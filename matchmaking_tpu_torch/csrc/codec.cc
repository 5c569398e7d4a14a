// Batch wire-request decoder: raw JSON bodies -> columnar arrays.
//
// The rebuild's native runtime component (SURVEY.md §2: the reference's
// native layer is the BEAM VM + Erlang AMQP stack; here the hot host-side
// loop is the wire codec, so it is C++). One call decodes a whole window of
// AMQP message bodies into the engine's RequestColumns layout; rows the fast
// path cannot express (parties, roles, escaped strings) are flagged
// NEEDS_PYTHON and re-decoded by the Python contract module (exact same
// validation rules — contract.decode_request is the semantic source of
// truth, and tests hold the two decoders to identical outputs).
//
// Build: g++ -O2 -shared -fPIC -o libmmcodec.so codec.cc   (no deps)
// Binding: ctypes (matchmaking_tpu/native/codec.py).

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <cmath>

namespace {

enum Status : int32_t {
  OK = 0,
  NEEDS_PYTHON = 1,   // party/roles present, escapes, or anything exotic
  BAD_JSON = 2,
  MISSING_FIELD = 3,
  BAD_TYPE = 4,
  BAD_RATING = 5,
  BAD_THRESHOLD = 6,
};

struct Cursor {
  const char* p;
  const char* end;
  bool ok = true;

  bool done() const { return p >= end; }
  char peek() const { return p < end ? *p : '\0'; }
  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
  }
};

// Skip any JSON value (used for keys we ignore). Depth-counted, no
// allocation. Returns false on malformed input.
bool skip_value(Cursor& c);

bool skip_string(Cursor& c) {
  // Assumes *c.p == '"'.
  ++c.p;
  while (c.p < c.end) {
    char ch = *c.p++;
    if (ch == '\\') {
      if (c.p < c.end) ++c.p;  // skip escaped char (incl. start of \uXXXX)
      continue;
    }
    if (ch == '"') return true;
  }
  return false;
}

// Strict JSON number grammar (RFC 8259: -?(0|[1-9][0-9]*)(\.[0-9]+)?
// ([eE][+-]?[0-9]+)?) plus Python json's non-standard Infinity/-Infinity/
// NaN literals (json.loads accepts them by default — *nonstd flags their
// use so value parsers can defer to Python instead of replicating its
// range-check semantics). A permissive [-+0-9.eE]* scan here previously
// let strtod accept `+5` and `5.`, which contract.decode_request (the
// semantic source of truth) rejects as bad_json — a live wire-contract
// divergence on the columnar hot path.
bool scan_number(Cursor& c, bool* nonstd) {
  *nonstd = false;
  const char* p = c.p;
  const char* end = c.end;
  if (p < end && *p == 'N') {
    if ((size_t)(end - p) >= 3 && memcmp(p, "NaN", 3) == 0) {
      c.p = p + 3; *nonstd = true; return true;
    }
    return false;
  }
  if (p < end && *p == '-') ++p;
  if (p < end && *p == 'I') {
    if ((size_t)(end - p) >= 8 && memcmp(p, "Infinity", 8) == 0) {
      c.p = p + 8; *nonstd = true; return true;
    }
    return false;
  }
  if (p >= end) return false;
  if (*p == '0') {
    ++p;  // a leading 0 takes no more digits (05 is malformed JSON)
  } else if (*p >= '1' && *p <= '9') {
    while (p < end && isdigit((unsigned char)*p)) ++p;
  } else {
    return false;  // covers leading '+' and bare '.'
  }
  if (p < end && *p == '.') {
    ++p;
    if (p >= end || !isdigit((unsigned char)*p)) return false;  // "5."
    while (p < end && isdigit((unsigned char)*p)) ++p;
  }
  if (p < end && (*p == 'e' || *p == 'E')) {
    ++p;
    if (p < end && (*p == '+' || *p == '-')) ++p;
    if (p >= end || !isdigit((unsigned char)*p)) return false;  // "5e"
    while (p < end && isdigit((unsigned char)*p)) ++p;
  }
  c.p = p;
  return true;
}

bool skip_literal(Cursor& c, const char* lit, size_t len) {
  if ((size_t)(c.end - c.p) < len || strncmp(c.p, lit, len) != 0) return false;
  c.p += len;
  return true;
}

bool skip_container(Cursor& c, char open, char close) {
  // Assumes *c.p == open.
  int depth = 0;
  while (c.p < c.end) {
    char ch = *c.p;
    if (ch == '"') {
      if (!skip_string(c)) return false;
      continue;
    }
    ++c.p;
    if (ch == open) ++depth;
    else if (ch == close) {
      if (--depth == 0) return true;
    }
  }
  return false;
}

bool skip_value(Cursor& c) {
  c.skip_ws();
  char ch = c.peek();
  if (ch == '"') return skip_string(c);
  if (ch == '{') return skip_container(c, '{', '}');
  if (ch == '[') return skip_container(c, '[', ']');
  if (ch == 't') return skip_literal(c, "true", 4);
  if (ch == 'f') return skip_literal(c, "false", 5);
  if (ch == 'n') return skip_literal(c, "null", 4);
  bool nonstd;  // ignored-key Infinity/NaN: json.loads accepts, so do we
  return scan_number(c, &nonstd);
}

// Parse a string value without escapes into [out, out+cap). Returns length,
// -1 on escape/overflow (-> NEEDS_PYTHON), -2 on malformed.
int parse_plain_string(Cursor& c, char* out, int cap) {
  if (c.peek() != '"') return -2;
  ++c.p;
  int n = 0;
  while (c.p < c.end) {
    char ch = *c.p++;
    if (ch == '"') return n;
    if (ch == '\\') return -1;
    if (n >= cap) return -1;
    out[n++] = ch;
  }
  return -2;
}

enum NumResult {
  NUM_OK = 0,
  NUM_BAD = 1,  // malformed numeric token → the whole payload is bad_json
  NUM_PY = 2,   // Infinity/NaN/huge: valid for json.loads — let Python's
                // own range checks decide (NEEDS_PYTHON)
};

NumResult parse_number(Cursor& c, double* out) {
  char buf[64];
  const char* start = c.p;
  bool nonstd = false;
  if (!scan_number(c, &nonstd)) return NUM_BAD;
  size_t len = c.p - start;
  if (nonstd || len >= sizeof(buf)) return NUM_PY;
  memcpy(buf, start, len);
  buf[len] = '\0';
  char* endp = nullptr;
  *out = strtod(buf, &endp);
  return endp == buf + len ? NUM_OK : NUM_BAD;
}

constexpr int kMaxStr = 256;  // per-field cap for id/region/mode strings

struct Row {
  char id[kMaxStr]; int id_len = -1;
  char region[kMaxStr]; int region_len = -1;
  char mode[kMaxStr]; int mode_len = -1;
  double rating = 0.0; bool has_rating = false;
  double rd = 350.0;
  double threshold = NAN;
  int32_t status = OK;
};

bool key_is(const char* key, int len, const char* name) {
  return (int)strlen(name) == len && memcmp(key, name, len) == 0;
}

// Numeric field value. Well-typed non-numbers (string/bool/null/object/
// array) are bad_type (contract's _req_number/_opt_number); a malformed
// numeric token means json.loads itself would have failed → bad_json;
// Infinity/NaN/over-long → NEEDS_PYTHON (Python's checks decide).
NumResult parse_number_field(Cursor& c, Row* row, double* out) {
  char pk = c.peek();
  if (pk == 't' || pk == 'f' || pk == 'n' || pk == '"' || pk == '{' ||
      pk == '[') {
    // Verify the token is well-formed before classifying: json.loads
    // fails a malformed token (bad_json) before any type check can run
    // (`nulx`, an unterminated string, ... must not report bad_type).
    row->status = skip_value(c) ? BAD_TYPE : BAD_JSON;
    return NUM_BAD;
  }
  NumResult r = parse_number(c, out);
  if (r == NUM_PY) row->status = NEEDS_PYTHON;
  else if (r == NUM_BAD) row->status = BAD_JSON;
  return r;
}

void decode_one(const char* buf, int len, Row& row) {
  Cursor c{buf, buf + len};
  c.skip_ws();
  if (c.peek() != '{') { row.status = BAD_JSON; return; }
  ++c.p;
  bool first = true;
  while (true) {
    c.skip_ws();
    if (c.peek() == '}') { ++c.p; break; }
    if (!first) {
      if (c.peek() != ',') { row.status = BAD_JSON; return; }
      // (comma consumed below after detecting it's not the first pair)
    }
    if (c.peek() == ',') ++c.p;
    first = false;
    c.skip_ws();
    char key[64];
    int klen = parse_plain_string(c, key, sizeof(key));
    if (klen == -1) { row.status = NEEDS_PYTHON; return; }
    if (klen < 0) { row.status = BAD_JSON; return; }
    c.skip_ws();
    if (c.peek() != ':') { row.status = BAD_JSON; return; }
    ++c.p;
    c.skip_ws();

    if (key_is(key, klen, "id")) {
      row.id_len = parse_plain_string(c, row.id, kMaxStr);
      if (row.id_len == -1) { row.status = NEEDS_PYTHON; return; }
      if (row.id_len < 0) {
        // Non-string id: bools/numbers are a type error per contract.
        if (!skip_value(c)) { row.status = BAD_JSON; return; }
        row.status = BAD_TYPE; return;
      }
    } else if (key_is(key, klen, "region")) {
      row.region_len = parse_plain_string(c, row.region, kMaxStr);
      if (row.region_len == -1) { row.status = NEEDS_PYTHON; return; }
      if (row.region_len < 0) {
        // contract: str(payload.get(...)) — non-strings coerce; punt.
        row.status = NEEDS_PYTHON;
        if (!skip_value(c)) row.status = BAD_JSON;
        return;
      }
    } else if (key_is(key, klen, "game_mode")) {
      row.mode_len = parse_plain_string(c, row.mode, kMaxStr);
      if (row.mode_len == -1) { row.status = NEEDS_PYTHON; return; }
      if (row.mode_len < 0) {
        row.status = NEEDS_PYTHON;
        if (!skip_value(c)) row.status = BAD_JSON;
        return;
      }
    } else if (key_is(key, klen, "rating")) {
      NumResult r = parse_number_field(c, &row, &row.rating);
      if (r != NUM_OK) return;
      row.has_rating = true;
    } else if (key_is(key, klen, "rating_deviation")) {
      if (parse_number_field(c, &row, &row.rd) != NUM_OK) return;
    } else if (key_is(key, klen, "rating_threshold")) {
      if (parse_number_field(c, &row, &row.threshold) != NUM_OK) return;
    } else if (key_is(key, klen, "roles") || key_is(key, klen, "party")) {
      // Non-empty arrays need the full Python decoder; [] is a no-op.
      c.skip_ws();
      if (c.peek() == '[') {
        const char* probe = c.p + 1;
        while (probe < c.end && (*probe == ' ' || *probe == '\n' ||
                                 *probe == '\t' || *probe == '\r'))
          ++probe;
        if (probe < c.end && *probe == ']') {
          c.p = probe + 1;
        } else {
          row.status = NEEDS_PYTHON;
          return;
        }
      } else {
        row.status = BAD_TYPE; return;
      }
    } else {
      if (!skip_value(c)) { row.status = BAD_JSON; return; }
    }
  }
  c.skip_ws();
  if (!c.done()) { row.status = BAD_JSON; return; }

  // Validation, mirroring contract.decode_request.
  if (row.id_len < 0 || !row.has_rating) { row.status = MISSING_FIELD; return; }
  if (!(row.rating > -1e5 && row.rating < 1e5)) { row.status = BAD_RATING; return; }
  if (row.rd < 0) { row.status = BAD_RATING; return; }
  if (!std::isnan(row.threshold) && row.threshold <= 0) {
    row.status = BAD_THRESHOLD; return;
  }
}

}  // namespace

extern "C" {

// Decode n message bodies. Outputs (caller-allocated):
//   rating[n] f32, rd[n] f32, threshold[n] f32 (NaN = absent),
//   status[n] i32, arena char buffer (cap bytes) holding id/region/mode
//   bytes back-to-back, offsets id_off/region_off/mode_off each [n+1]
//   (empty string = region/mode absent -> wildcard).
// Returns bytes used in arena, or -1 if the arena overflowed (caller
// retries with a bigger arena).
int64_t mm_decode_requests(const char** bufs, const int32_t* lens, int32_t n,
                           float* rating, float* rd, float* threshold,
                           int32_t* status, char* arena, int64_t cap,
                           int64_t* id_off, int64_t* region_off,
                           int64_t* mode_off) {
  int64_t used = 0;
  for (int32_t i = 0; i < n; ++i) {
    Row row;
    decode_one(bufs[i], lens[i], row);
    status[i] = row.status;
    rating[i] = (float)row.rating;
    rd[i] = (float)row.rd;
    threshold[i] = (float)row.threshold;
    id_off[i] = used;
    if (row.status == OK) {
      if (used + row.id_len > cap) return -1;
      memcpy(arena + used, row.id, row.id_len);
      used += row.id_len;
    }
    region_off[i] = used;
    if (row.status == OK && row.region_len > 0) {
      if (used + row.region_len > cap) return -1;
      memcpy(arena + used, row.region, row.region_len);
      used += row.region_len;
    }
    mode_off[i] = used;
    if (row.status == OK && row.mode_len > 0) {
      if (used + row.mode_len > cap) return -1;
      memcpy(arena + used, row.mode, row.mode_len);
      used += row.mode_len;
    }
    // Sentinel end for row i is the next row's id_off (or final `used`).
  }
  id_off[n] = used;
  region_off[n] = used;  // unused; kept for symmetric shape
  mode_off[n] = used;
  return used;
}

// Concat variant (the consume_batch ingress layout): identical
// row decode, but the input is ONE contiguous buffer of n bodies packed
// back-to-back with offsets `boff` ([n+1]; body i spans boff[i]..boff[i+1])
// — the mirror of the encoders' arena+offset OUTPUT layout, so a consume
// burst's bodies flow broker → decoder without materializing a per-row
// pointer table. Same outputs and arena contract as mm_decode_requests;
// a row whose offsets are inverted or out of bounds is BAD_JSON (hostile
// offsets must not read outside the buffer).
int64_t mm_decode_requests_concat(const char* buf, int64_t buf_len,
                                  const int64_t* boff, int32_t n,
                                  float* rating, float* rd, float* threshold,
                                  int32_t* status, char* arena, int64_t cap,
                                  int64_t* id_off, int64_t* region_off,
                                  int64_t* mode_off) {
  int64_t used = 0;
  for (int32_t i = 0; i < n; ++i) {
    Row row;
    int64_t b0 = boff[i], b1 = boff[i + 1];
    if (b0 < 0 || b1 < b0 || b1 > buf_len || b1 - b0 > 0x7fffffff) {
      row.status = BAD_JSON;
    } else {
      decode_one(buf + b0, (int)(b1 - b0), row);
    }
    status[i] = row.status;
    rating[i] = (float)row.rating;
    rd[i] = (float)row.rd;
    threshold[i] = (float)row.threshold;
    id_off[i] = used;
    if (row.status == OK) {
      if (used + row.id_len > cap) return -1;
      memcpy(arena + used, row.id, row.id_len);
      used += row.id_len;
    }
    region_off[i] = used;
    if (row.status == OK && row.region_len > 0) {
      if (used + row.region_len > cap) return -1;
      memcpy(arena + used, row.region, row.region_len);
      used += row.region_len;
    }
    mode_off[i] = used;
    if (row.status == OK && row.mode_len > 0) {
      if (used + row.mode_len > cap) return -1;
      memcpy(arena + used, row.mode, row.mode_len);
      used += row.mode_len;
    }
  }
  id_off[n] = used;
  region_off[n] = used;
  mode_off[n] = used;
  return used;
}

}  // extern "C"

// ---- batch response encoder ------------------------------------------------
//
// The egress twin of mm_decode_requests: one call builds the JSON bodies for
// a whole window of responses (matched pairs, queued acks, timeouts, sheds —
// at grouped-readback match rates the per-response Python dict+json.dumps is
// the service's next hot loop). Bodies are BYTE-IDENTICAL to
// contract.encode_response (pinned by the fuzz corpus in
// tests/test_codec_fuzz.py): same key order, and floats formatted exactly as
// Python's json.dumps(round(x, k)) — py_round replicates round()'s
// correctly-rounded half-even decimal rounding via printf ("%.*f" is
// correctly rounded with ties-to-even under glibc) + strtod, and py_repr
// replicates float.__repr__'s shortest-round-trip digits + CPython's
// fixed-vs-scientific threshold (fixed for -4 < dp <= 16). Rows the exact
// contract cannot express natively (non-ASCII — json.dumps escapes to
// \uXXXX from decoded text, which bytes-level C cannot see — or non-finite
// floats) are flagged NEEDS_PYTHON per row and re-encoded by the Python
// contract module, never approximated.

namespace {

enum EncResult {
  E_OK = 0,
  E_OVERFLOW = 1,   // arena too small: caller retries with a bigger one
  E_PY = 2,         // row needs the Python encoder (exact-contract fallback)
};

// round(x, k) as CPython computes it: correctly-rounded k-digit decimal
// (ties to even) re-parsed to the nearest double.
double py_round(double v, int decimals) {
  char buf[512];
  int len = snprintf(buf, sizeof buf, "%.*f", decimals, v);
  if (len <= 0 || len >= (int)sizeof buf) return v;  // |v| ~ 1e308 handled;
                                                     // unreachable otherwise
  return strtod(buf, nullptr);
}

// float.__repr__(v): shortest digit string that round-trips, formatted with
// CPython's fixed/scientific threshold. Returns bytes written, -1 on
// overflow, -2 for non-finite input (NEEDS_PYTHON).
int64_t py_repr(double v, char* out, int64_t cap) {
  if (!std::isfinite(v)) return -2;
  char digits[32];
  int exp10 = 0;
  {
    char buf[64];
    int prec;
    for (prec = 0; prec < 17; ++prec) {  // prec+1 significant digits
      int len = snprintf(buf, sizeof buf, "%.*e", prec, v);
      if (len <= 0 || len >= (int)sizeof buf) return -2;
      char* endp = nullptr;
      double back = strtod(buf, &endp);
      if (endp == buf + len && memcmp(&back, &v, sizeof v) == 0) break;
    }
    if (prec == 17) --prec;  // %.16e (17 digits) always round-trips
    // Parse "[-]d.ddddde±XX" into bare digits + decimal exponent.
    const char* p = buf;
    if (*p == '-') ++p;
    int nd = 0;
    digits[nd++] = *p++;
    if (*p == '.') {
      ++p;
      while (*p && *p != 'e' && *p != 'E') digits[nd++] = *p++;
    }
    while (*p && *p != 'e' && *p != 'E') ++p;
    if (*p) exp10 = (int)strtol(p + 1, nullptr, 10);
    // Strip trailing zeros the round-trip search may have kept (e.g. 10.0
    // needs 1 digit but %.0e prints "1e+01" — already minimal; 1230.0
    // prints "1.23e+03" at prec 2 — minimal too; zeros only survive when
    // a shorter form failed to round-trip, where they are significant).
    digits[nd] = '\0';
  }
  int nd = (int)strlen(digits);
  int dp = exp10 + 1;  // digits before the decimal point (CPython's "dp")
  char buf[64];
  int w = 0;
  if (v < 0.0 || (v == 0.0 && std::signbit(v))) buf[w++] = '-';
  if (-4 <= exp10 && dp <= 16) {
    // Fixed notation (CPython: -4 < dp <= 16, dp = exp10 + 1).
    if (dp <= 0) {
      buf[w++] = '0'; buf[w++] = '.';
      for (int i = 0; i < -dp; ++i) buf[w++] = '0';
      memcpy(buf + w, digits, nd); w += nd;
    } else if (dp >= nd) {
      memcpy(buf + w, digits, nd); w += nd;
      for (int i = nd; i < dp; ++i) buf[w++] = '0';
      buf[w++] = '.'; buf[w++] = '0';
    } else {
      memcpy(buf + w, digits, dp); w += dp;
      buf[w++] = '.';
      memcpy(buf + w, digits + dp, nd - dp); w += nd - dp;
    }
  } else {
    // Scientific notation, CPython style: d[.ddd]e±XX (>= 2 exp digits).
    buf[w++] = digits[0];
    if (nd > 1) {
      buf[w++] = '.';
      memcpy(buf + w, digits + 1, nd - 1); w += nd - 1;
    }
    w += snprintf(buf + w, sizeof buf - w, "e%+03d", exp10);
  }
  if (w > cap) return -1;
  memcpy(out, buf, w);
  return w;
}

// Escape one ASCII string exactly as json.dumps (ensure_ascii default)
// does. Returns bytes written, -1 on overflow, -2 when a byte >= 0x80 is
// seen — json.dumps escapes non-ASCII from DECODED text (\uXXXX over code
// points), which a bytes-level encoder cannot replicate; those rows take
// the Python encoder.
int64_t esc_json(const char* s, char* out, int64_t cap) {
  static const char* hex = "0123456789abcdef";
  int64_t w = 0;
  for (const char* p = s; *p; ++p) {
    unsigned char ch = (unsigned char)*p;
    if (ch >= 0x80) return -2;
    if (ch == '"' || ch == '\\') {
      if (w + 2 > cap) return -1;
      out[w++] = '\\'; out[w++] = (char)ch;
    } else if (ch < 0x20) {
      if (ch == '\n' || ch == '\t' || ch == '\r' || ch == '\b' || ch == '\f') {
        if (w + 2 > cap) return -1;
        out[w++] = '\\';
        out[w++] = ch == '\n' ? 'n' : ch == '\t' ? 't' : ch == '\r' ? 'r'
                   : ch == '\b' ? 'b' : 'f';
      } else {
        if (w + 6 > cap) return -1;
        out[w++] = '\\'; out[w++] = 'u'; out[w++] = '0'; out[w++] = '0';
        out[w++] = hex[ch >> 4]; out[w++] = hex[ch & 15];
      }
    } else {
      if (w + 1 > cap) return -1;
      out[w++] = (char)ch;
    }
  }
  return w;
}

struct Writer {
  char* out;
  int64_t cap;
  int64_t w = 0;
  EncResult err = E_OK;

  bool ok() const { return err == E_OK; }
  void lit(const char* s) {
    int64_t n = (int64_t)strlen(s);
    if (err != E_OK) return;
    if (w + n > cap) { err = E_OVERFLOW; return; }
    memcpy(out + w, s, n); w += n;
  }
  void str(const char* s) {
    if (err != E_OK) return;
    if (w + 1 > cap) { err = E_OVERFLOW; return; }
    out[w++] = '"';
    int64_t n = esc_json(s, out + w, cap - w);
    if (n < 0) { err = n == -1 ? E_OVERFLOW : E_PY; return; }
    w += n;
    if (w + 1 > cap) { err = E_OVERFLOW; return; }
    out[w++] = '"';
  }
  // json.dumps(round(v, decimals)) byte for byte.
  void num(double v, int decimals) {
    if (err != E_OK) return;
    int64_t n = py_repr(py_round(v, decimals), out + w, cap - w);
    if (n < 0) { err = n == -1 ? E_OVERFLOW : E_PY; return; }
    w += n;
  }
  void integer(int32_t v) {
    if (err != E_OK) return;
    char buf[16];
    int n = snprintf(buf, sizeof buf, "%d", v);
    if (w + n > cap) { err = E_OVERFLOW; return; }
    memcpy(out + w, buf, n); w += n;
  }
};

// {"status":"matched","player_id":P,"latency_ms":L,"match":{"match_id":M,
//  "players":[A,B],"teams":[[A],[B]],"quality":Q},"waited_ms":W
//  [,"trace_id":T]} — contract.encode_response key order exactly.
void encode_one_matched(Writer& wr, const char* pid, const char* mid,
                        const char* a, const char* b, double lat_ms,
                        double quality, double waited_ms,
                        const char* trace_id) {
  wr.lit("{\"status\":\"matched\",\"player_id\":");
  wr.str(pid);
  wr.lit(",\"latency_ms\":");
  wr.num(lat_ms, 3);
  wr.lit(",\"match\":{\"match_id\":");
  wr.str(mid);
  wr.lit(",\"players\":[");
  wr.str(a); wr.lit(","); wr.str(b);
  wr.lit("],\"teams\":[[");
  wr.str(a); wr.lit("],["); wr.str(b);
  wr.lit("]],\"quality\":");
  wr.num(quality, 6);
  wr.lit("},\"waited_ms\":");
  wr.num(waited_ms, 3);
  if (trace_id && trace_id[0]) {
    wr.lit(",\"trace_id\":");
    wr.str(trace_id);
  }
  wr.lit("}");
}

const char* kSimpleStatus[] = {"queued", "timeout", "shed"};

// queued:  {"status":"queued","player_id":P,"latency_ms":L[,"trace_id":T]
//           [,"tier":N]}
// timeout: {"status":"timeout","player_id":P,"latency_ms":L[,"trace_id":T]
//           [,"tier":N]}
// shed:    {"status":"shed","player_id":P,"latency_ms":L,
//           "retry_after_ms":R[,"trace_id":T][,"tier":N]}
void encode_one_simple(Writer& wr, int32_t kind, const char* pid,
                       double lat_ms, double retry_ms, const char* trace_id,
                       int32_t tier) {
  wr.lit("{\"status\":\"");
  wr.lit(kSimpleStatus[kind]);
  wr.lit("\",\"player_id\":");
  wr.str(pid);
  wr.lit(",\"latency_ms\":");
  wr.num(lat_ms, 3);
  if (kind == 2) {
    wr.lit(",\"retry_after_ms\":");
    wr.num(retry_ms, 3);
  }
  if (trace_id && trace_id[0]) {
    wr.lit(",\"trace_id\":");
    wr.str(trace_id);
  }
  if (tier >= 0) {
    wr.lit(",\"tier\":");
    wr.integer(tier);
  }
  wr.lit("}");
}

// Shared per-row epilogue: E_PY rows rewind to the row start and are
// flagged NEEDS_PYTHON (status[j] = 1; Python re-encodes just that row);
// E_OVERFLOW aborts the whole call (caller retries with a bigger arena).
bool finish_row(Writer& wr, int64_t row_start, int32_t* status, int64_t j) {
  if (wr.err == E_PY) {
    wr.w = row_start;
    wr.err = E_OK;
    status[j] = 1;
  } else {
    status[j] = 0;
  }
  return wr.err == E_OK;
}

}  // namespace

extern "C" {

// Encode 2n matched responses (players a and b of n matches) into `arena`;
// body j spans arena[off[j] .. off[j+1]) with order a0,b0,a1,b1,...
// status[j]: 0 = OK, 1 = NEEDS_PYTHON (empty span; re-encode row j via the
// Python contract). trace_a/trace_b may be NULL (no trace ids at all); ""
// entries omit the key. Returns bytes used, or -1 if the arena overflowed
// (caller retries bigger). Strings are NUL-terminated ASCII/UTF-8.
int64_t mm_encode_matched(const char** id_a, const char** id_b,
                          const char** match_id, int32_t n,
                          const double* lat_a, const double* lat_b,
                          const double* quality,
                          const double* waited_a, const double* waited_b,
                          const char** trace_a, const char** trace_b,
                          char* arena, int64_t cap, int64_t* off,
                          int32_t* status) {
  Writer wr{arena, cap};
  for (int32_t i = 0; i < n; ++i) {
    off[2 * i] = wr.w;
    encode_one_matched(wr, id_a[i], match_id[i], id_a[i], id_b[i],
                       lat_a[i], quality[i], waited_a[i],
                       trace_a ? trace_a[i] : nullptr);
    if (!finish_row(wr, off[2 * i], status, 2 * i)) return -1;
    off[2 * i + 1] = wr.w;
    encode_one_matched(wr, id_b[i], match_id[i], id_a[i], id_b[i],
                       lat_b[i], quality[i], waited_b[i],
                       trace_b ? trace_b[i] : nullptr);
    if (!finish_row(wr, off[2 * i + 1], status, 2 * i + 1)) return -1;
  }
  off[2 * n] = wr.w;
  return wr.w;
}

// Encode n queued/timeout/shed responses (kind[i]: 0/1/2). tier[i] < 0
// omits the key (untiered services); trace_id may be NULL. Same status /
// retry contract as mm_encode_matched.
int64_t mm_encode_simple(const int32_t* kind, const char** player_id,
                         const double* lat_ms, const double* retry_ms,
                         const char** trace_id, const int32_t* tier,
                         int32_t n, char* arena, int64_t cap, int64_t* off,
                         int32_t* status) {
  Writer wr{arena, cap};
  for (int32_t i = 0; i < n; ++i) {
    off[i] = wr.w;
    if (kind[i] < 0 || kind[i] > 2) { status[i] = 1; continue; }
    encode_one_simple(wr, kind[i], player_id[i], lat_ms[i], retry_ms[i],
                      trace_id ? trace_id[i] : nullptr, tier[i]);
    if (!finish_row(wr, off[i], status, i)) return -1;
  }
  off[n] = wr.w;
  return wr.w;
}

}  // extern "C"
