"""The port's configuration: the repository's JSON files load with no key
dropped, and every field the port carries has the JAX package's name and
default."""

import dataclasses
import json
import logging
import os

import pytest

from matchmaking_tpu import config as jax_config
from matchmaking_tpu_torch import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Configs #1, #2 and #4, and the latency preset.
FILES = ("elo_1v1.json", "multiqueue_filters.json", "glicko2.json",
         "latency.json")


@pytest.mark.parametrize("name", FILES)
def test_config_file_loads_without_dropping_a_key(name, caplog):
    path = os.path.join(ROOT, "configs", name)
    with caplog.at_level(logging.WARNING, logger=config.__name__):
        cfg = config.Config.from_json(path, backend="gpu")
    assert not caplog.records, [r.getMessage() for r in caplog.records]
    with open(path) as f:
        raw = json.load(f)
    for i, q in enumerate(raw["queues"]):
        for key, value in q.items():
            assert getattr(cfg.queues[i], key) == value, key
    for section, keys in raw.items():
        if section in ("queues", "_comment"):
            continue
        for key, value in keys.items():
            want = tuple(value) if isinstance(value, list) else value
            if (section, key) == ("engine", "backend"):
                want = "gpu"  # the port's backend, given at load time
            assert getattr(getattr(cfg, section), key) == want, (section, key)


@pytest.mark.parametrize("section", ["QueueConfig", "EngineConfig",
                                     "BrokerConfig", "BatcherConfig",
                                     "AuthConfig", "OverloadConfig",
                                     "ObservabilityConfig",
                                     "DurabilityConfig", "ForensicsConfig",
                                     "ChaosConfig", "ReplicationConfig",
                                     "NetConfig"])
def test_port_fields_have_the_jax_names_and_defaults(section):
    port, jax = getattr(config, section)(), getattr(jax_config, section)()
    for f in dataclasses.fields(port):
        if (section, f.name) == ("EngineConfig", "backend"):
            assert (port.backend, jax.backend) == ("gpu", "cpu")
            continue
        assert getattr(port, f.name) == getattr(jax, f.name), f.name


@pytest.mark.parametrize("name", ["team_5v5.json", "role_party.json"])
def test_team_and_role_files_load(name, caplog):
    """Configs #3 and #5: every key is carried (role slots as a tuple),
    the team knobs with the JAX package's names and defaults."""
    path = os.path.join(ROOT, "configs", name)
    with caplog.at_level(logging.WARNING, logger=config.__name__):
        cfg = config.Config.from_json(path, backend="gpu")
    assert not caplog.records, [r.getMessage() for r in caplog.records]
    want = jax_config.Config.from_json(path)
    q, jq = cfg.queues[0], want.queues[0]
    assert q.team_size == jq.team_size == 5
    assert q.role_slots == tuple(jq.role_slots)
    for f in dataclasses.fields(q):
        assert getattr(q, f.name) == getattr(jq, f.name) or (
            f.name == "role_slots"), f.name
    for key in ("pool_capacity", "team_max_matches", "team_rounds"):
        assert getattr(cfg.engine, key) == getattr(want.engine, key), key
    assert cfg.engine.backend == "gpu"


def test_the_loops_read_their_knobs():
    cfg = config.Config.from_json(os.path.join(ROOT, "configs", "glicko2.json"),
                                  backend="gpu")
    assert cfg.queues[0].rescan_interval_s == 1.0
    lat = config.Config.from_json(os.path.join(ROOT, "configs", "latency.json"),
                                  backend="gpu")
    assert (lat.engine.pipeline_depth, lat.engine.readback_group,
            lat.engine.warm_start) == (1, 1, True)
    assert lat.batcher.max_batch == 512


def test_observability_and_pruning_keys_load(caplog):
    """The quality, tracing, telemetry and SLO burn keys and the pruning
    knobs load with their JAX names and defaults, as do the forensics
    section (the spine ring and the incident capture) and the top-level
    ``metrics_port`` / ``metrics_host``; nothing warns."""
    raw = {"queues": [{}],
           "engine": {"prune_window_blocks": 6, "prune_chunk": 128,
                      "band_spec": "gaussian:1500:300"},
           "observability": {"quality_rating_edges": [1200.0, 1800.0],
                             "quality_buckets": 10,
                             "quality_report_every": 4,
                             "quality_slo_target": 0.5,
                             "slo_target_ms": 50.0,
                             "trace_sample_n": 4,
                             "stage_buckets": [0.01, 0.001],
                             "snapshot_interval_s": 2.0,
                             "telemetry_ring": 64,
                             "slo_objective": 0.95,
                             "slo_fast_window_s": 5.0,
                             "slo_slow_window_s": 30.0,
                             "slo_burn_threshold": 2.0,
                             "profile_dir": "prof"},
           "forensics": {"spine_ring": 128, "capture": False,
                         "incident_dir": "inc", "min_interval_s": 1.0},
           "metrics_port": 9100, "metrics_host": "0.0.0.0"}
    with caplog.at_level(logging.WARNING, logger=config.__name__):
        cfg = config.Config.from_dict(raw, backend="gpu")
    assert [r.getMessage() for r in caplog.records] == []
    want = jax_config.Config.from_dict(raw)
    for f in dataclasses.fields(config.ObservabilityConfig):
        assert (getattr(cfg.observability, f.name)
                == getattr(want.observability, f.name)), f.name
    for f in dataclasses.fields(config.ForensicsConfig):
        assert (getattr(cfg.forensics, f.name)
                == getattr(want.forensics, f.name)), f.name
    assert (cfg.metrics_port, cfg.metrics_host) == (
        want.metrics_port, want.metrics_host) == (9100, "0.0.0.0")
    assert cfg.observability.snapshot_interval_s == 2.0
    assert not cfg.forensics.enabled() and not want.forensics.enabled()
    for key in ("prune_window_blocks", "prune_chunk", "band_spec"):
        assert getattr(cfg.engine, key) == getattr(want.engine, key), key
    for key in ("quality_rating_edges", "quality_buckets",
                "quality_report_every", "quality_slo_target",
                "quality_slo_objective", "quality_wait_buckets", "trace",
                "trace_sample_n", "trace_ring", "slow_trace_ring",
                "slow_trace_ms", "event_ring", "slo_target_ms"):
        assert (getattr(cfg.observability, key)
                == getattr(want.observability, key)), key
    assert tuple(cfg.observability.stage_buckets) == tuple(
        want.observability.stage_buckets) == (0.01, 0.001)
    assert cfg.forensics.spine_ring == want.forensics.spine_ring == 128
    default, jdefault = config.Config(), jax_config.Config()
    for key in ("trace", "trace_sample_n", "trace_ring", "slow_trace_ring",
                "slow_trace_ms", "event_ring", "stage_buckets",
                "slo_target_ms"):
        assert (getattr(default.observability, key)
                == getattr(jdefault.observability, key)), key
    assert default.observability.trace is True
    assert default.forensics.spine_ring == jdefault.forensics.spine_ring
    # The sampler and the capture are on by default, as in the JAX app.
    assert default.observability.snapshot_interval_s == 1.0
    assert default.forensics.enabled() and jdefault.forensics.enabled()
    assert (default.metrics_port, default.metrics_host) == (
        jdefault.metrics_port, jdefault.metrics_host) == (0, "127.0.0.1")
    assert cfg.observability.quality_rating_edges == (1200.0, 1800.0)


@pytest.mark.parametrize("knob", [{"bucketed": True, "bucket_frontier_k": 4},
                                  {"bucket_frontier_k": 4}])
def test_gpu_engine_refuses_the_bucketed_step(knob):
    """The sharded bucket frontier (``bucket_frontier_k`` > 0) is not
    ported: a config that asks for it, with bucketed formation or
    without, is refused, not run some other way. (Bucketed formation on
    one device is served: tests/test_torch_bucketed.py.)"""
    from matchmaking_tpu_torch.engine.gpu import GpuEngine

    cfg = config.Config(engine=config.EngineConfig(pool_capacity=1024,
                                                   pool_block=256, **knob))
    with pytest.raises(ValueError, match="bucket_frontier_k"):
        GpuEngine(cfg, cfg.queues[0], device="cpu")


def test_bucketed_and_spec_keys_load_with_the_jax_names_and_defaults():
    """``engine.bucketed`` and the four ``engine.spec_*`` keys load under
    the JAX names, with the JAX defaults when absent."""
    keys = ("bucketed", "spec_formation", "spec_max_steps",
            "spec_staleness_ms", "spec_interval_ms")
    default, jax_default = config.EngineConfig(), jax_config.EngineConfig()
    for key in keys:
        assert getattr(default, key) == getattr(jax_default, key), key
    raw = {"queues": [{}], "engine": {
        "bucketed": True, "spec_formation": True, "spec_max_steps": 3,
        "spec_staleness_ms": 250.0, "spec_interval_ms": 5.0}}
    cfg = config.Config.from_dict(raw, backend="gpu")
    assert [getattr(cfg.engine, k) for k in keys] == [True, True, 3, 250.0,
                                                      5.0]


def test_health_interval_loads_with_the_jax_meaning():
    """``engine.health_interval_s`` (the service's health timer; 0 turns
    it off) loads under the JAX name, as the JAX package reads it."""
    raw = {"queues": [{}], "engine": {"health_interval_s": 0.25}}
    cfg = config.Config.from_dict(raw, backend="gpu")
    assert (cfg.engine.health_interval_s
            == jax_config.Config.from_dict(raw).engine.health_interval_s
            == 0.25)
    assert config.EngineConfig().health_interval_s == 1.0


def test_durability_auth_and_drain_keys_load_like_jax():
    d = {"durability": {"journal_dir": "/tmp/j", "fsync": "window",
                        "fsync_interval_s": 0.02, "compact_records": 99,
                        "compact_bytes": 1 << 20, "compact_interval_s": 0.5,
                        "keep_snapshots": 3},
         "auth": {"mode": "rpc", "static_secret": "s", "rpc_queue": "a.q",
                  "rpc_timeout_ms": 50.0},
         "overload": {"drain_checkpoint_dir": "/tmp/d"},
         "broker": {"url": "inproc://x"}}
    cfg, jcfg = config.Config.from_dict(d), jax_config.Config.from_dict(d)
    for section in ("durability", "auth", "overload", "broker"):
        port, jax = getattr(cfg, section), getattr(jcfg, section)
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(jax, f.name), (
                section, f.name)
    assert cfg.durability.enabled() and cfg.overload.enabled()


def test_a_replication_role_is_refused_naming_the_module(caplog):
    """``replication.role`` loads now that service/replication.py is
    ported; an unknown role is refused by ``enabled()``, as in the JAX
    package, naming the roles there are."""
    with caplog.at_level(logging.WARNING, logger=config.__name__):
        cfg = config.Config.from_dict({"replication": {
            "role": "primary", "owner": "hostA", "pump_interval_s": 0.05}})
    assert not caplog.records, [r.getMessage() for r in caplog.records]
    want = jax_config.Config.from_dict({"replication": {
        "role": "primary", "owner": "hostA", "pump_interval_s": 0.05}})
    assert dataclasses.asdict(cfg.replication) == dataclasses.asdict(
        want.replication)
    assert cfg.replication.enabled() and want.replication.enabled()
    assert not config.ReplicationConfig().enabled()
    for mod in (config, jax_config):
        with pytest.raises(ValueError, match="unknown replication role"):
            mod.Config.from_dict(
                {"replication": {"role": "standby"}}).replication.enabled()


#: Every broker fault key of ``chaos``, every ``repl_*`` key, the
#: ``broker`` faults and the top-level scalars, with values that are not
#: their defaults.
FAULT_KEYS = {
    "chaos": {"seed": 4, "queues": ["q"], "drop_prob": 0.1, "dup_prob": 0.2,
              "drop_seqs": [0, 5], "dup_seqs": [[1, 2]],
              "partitions": [[6, 9]], "partition_max_s": 2.5,
              "repl_drop_seqs": [3], "repl_dup_seqs": [4],
              "repl_delay_seqs": [[5, 2]], "repl_partitions": [[7, 9]],
              "repl_drop_prob": 0.05, "repl_fail_renewals": [0, 2]},
    "broker": {"drop_prob": 0.01, "dup_prob": 0.02, "delay_ms": 1.5},
    "replication": {"role": "primary", "owner": "h", "pump_interval_s": 0.1},
}


def test_fault_and_replication_keys_load_like_jax_from_json(tmp_path,
                                                            caplog):
    raw = {**FAULT_KEYS, "seed": 11, "debug_invariants": True,
           "queues": [{"name": "q"}]}
    path = tmp_path / "faults.json"
    path.write_text(json.dumps(raw))
    with caplog.at_level(logging.WARNING, logger=config.__name__):
        cfg = config.Config.from_json(str(path), backend="gpu")
    assert not caplog.records, [r.getMessage() for r in caplog.records]
    want = jax_config.Config.from_json(str(path))
    for section in FAULT_KEYS:
        for key in FAULT_KEYS[section]:
            assert (getattr(getattr(cfg, section), key)
                    == getattr(getattr(want, section), key)), (section, key)
    assert (cfg.seed, cfg.debug_invariants) == (
        want.seed, want.debug_invariants) == (11, True)
    assert cfg.chaos.dup_seqs == ((1, 2),) and cfg.chaos.repl_delay_seqs == (
        (5, 2),)
    for gate in ("enabled", "consume_faults", "publish_faults",
                 "replication_faults"):
        assert getattr(cfg.chaos, gate)() == getattr(want.chaos, gate)(), gate
    default, jdefault = config.Config(), jax_config.Config()
    assert (default.seed, default.debug_invariants) == (
        jdefault.seed, jdefault.debug_invariants) == (0, False)
    only_repl = config.ChaosConfig(repl_drop_seqs=(1,))
    assert only_repl.replication_faults() and not only_repl.enabled()


def test_fault_and_replication_keys_load_like_jax_from_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("MM_"):
            monkeypatch.delenv(k)
    for section, keys in FAULT_KEYS.items():
        for key, value in keys.items():
            monkeypatch.setenv(f"MM_{section.upper()}_{key.upper()}",
                               json.dumps(value))
    monkeypatch.setenv("MM_SEED", "9")
    monkeypatch.setenv("MM_DEBUG_INVARIANTS", "true")
    cfg, want = config.Config.from_env(), jax_config.Config.from_env()
    for section in FAULT_KEYS:
        for key in FAULT_KEYS[section]:
            assert (getattr(getattr(cfg, section), key)
                    == getattr(getattr(want, section), key)), (section, key)
    assert (cfg.seed, cfg.debug_invariants) == (9, True) == (
        want.seed, want.debug_invariants)


def test_net_keys_still_warn_and_device_loss_is_still_refused(caplog):
    """The ``net`` section and the ``net_*`` chaos keys load now that
    net/ is ported; ``workers`` still warns, and the multi-GPU chaos key
    is still refused."""
    with caplog.at_level(logging.WARNING, logger=config.__name__):
        cfg = config.Config.from_dict({
            "chaos": {"net_drop_prob": 0.5, "net_deaf_flows": ["lease:"],
                      "drop_seqs": [1]},
            "net": {"transport": "socket"}, "workers": 4})
    said = " ".join(r.getMessage() for r in caplog.records)
    assert "'workers'" in said
    for key in ("net_drop_prob", "net_deaf_flows", "'net'"):
        assert key not in said, key
    assert cfg.chaos.drop_seqs == (1,)
    assert cfg.chaos.net_deaf_flows == ("lease:",)
    assert cfg.net.enabled()
    with pytest.raises(ValueError, match="multi-GPU"):
        config.Config.from_dict({"chaos": {"device_lost_steps": [2]}})


#: Every ``net`` key and every ``net_*`` chaos key, with values that are
#: not their defaults.
NET_KEYS = {
    "net": {"transport": "socket", "lease_addr": "unix:/tmp/l.sock",
            "repl_target": "tcp:10.0.0.2:7001", "connect_timeout_s": 2.5,
            "request_timeout_s": 0.75, "heartbeat_interval_s": 0.05,
            "heartbeat_timeout_s": 0.9, "reconnect_base_s": 0.01,
            "reconnect_cap_s": 2.0, "max_frame_bytes": 33554432,
            "send_buffer_bytes": 16777216, "lease_rtt_budget_s": 0.2},
    "chaos": {"net_drop_frames": [["fwd", 2]],
              "net_dup_frames": [["fwd", 3], ["ack", 1]],
              "net_delay_frames": [["fwd", 4, 2]],
              "net_reset_frames": [["repl:q:fwd", 6]],
              "net_partitions": [["fwd", 8, 12]],
              "net_deaf_flows": ["lease:", "repl:q:ack"],
              "net_drop_prob": 0.05,
              "net_bandwidth_caps": [["fwd", 1048576]]},
}


def _net_equal(cfg, want):
    for section, keys in NET_KEYS.items():
        for key in keys:
            mine = getattr(getattr(cfg, section), key)
            theirs = getattr(getattr(want, section), key)
            assert mine == theirs or tuple(map(tuple, mine)) == tuple(
                map(tuple, theirs)), (section, key, mine, theirs)


@pytest.mark.parametrize("source", ["json", "env"])
def test_net_keys_load_like_jax(source, tmp_path, monkeypatch, caplog):
    """Every ``net`` key and ``net_*`` chaos key from a JSON file and from
    ``MM_NET_*`` / ``MM_CHAOS_NET_*``, equal to the JAX package's;
    ``net_faults()`` equals JAX's on each key alone, and ``enabled()``
    counts none of them, as in JAX."""
    for k in list(os.environ):
        if k.startswith("MM_"):
            monkeypatch.delenv(k)
    if source == "json":
        path = tmp_path / "net.json"
        path.write_text(json.dumps({**NET_KEYS, "queues": [{"name": "q"}]}))
        with caplog.at_level(logging.WARNING, logger=config.__name__):
            cfg = config.Config.from_json(str(path), backend="gpu")
        assert not caplog.records, [r.getMessage() for r in caplog.records]
        want = jax_config.Config.from_json(str(path))
    else:
        for section, keys in NET_KEYS.items():
            for key, value in keys.items():
                monkeypatch.setenv(f"MM_{section.upper()}_{key.upper()}",
                                   json.dumps(value))
        cfg, want = config.Config.from_env(), jax_config.Config.from_env()
    _net_equal(cfg, want)
    assert cfg.net.enabled() and want.net.enabled()
    assert cfg.chaos.net_faults() and want.chaos.net_faults()
    assert not cfg.chaos.enabled() and not want.chaos.enabled()
    for key, value in NET_KEYS["chaos"].items():
        one = config.Config.from_dict({"chaos": {key: value}}).chaos
        jone = jax_config.Config.from_dict({"chaos": {key: value}}).chaos
        assert one.net_faults() == jone.net_faults() is True, key
        assert one.enabled() == jone.enabled() is False, key
    assert (config.ChaosConfig().net_faults()
            == jax_config.ChaosConfig().net_faults() is False)


def test_net_defaults_and_unknown_transport_like_jax():
    port, jax = config.Config().net, jax_config.Config().net
    assert dataclasses.asdict(port) == dataclasses.asdict(jax)
    assert (port.heartbeat_interval_s, port.heartbeat_timeout_s,
            port.max_frame_bytes, port.send_buffer_bytes,
            port.lease_rtt_budget_s) == (0.1, 0.6, 1 << 20, 4 << 20, 0.05)
    assert not port.enabled() and not jax.enabled()
    for t in ("", "inproc"):
        assert not config.NetConfig(transport=t).enabled()
    for mod in (config, jax_config):
        with pytest.raises(ValueError, match="unknown net transport"):
            mod.NetConfig(transport="tcp").enabled()


def test_from_env_reads_the_mm_variables_like_jax(tmp_path, monkeypatch):
    path = tmp_path / "cfg.json"
    with open(os.path.join(ROOT, "configs", "multiqueue_filters.json")) as f:
        path.write_text(f.read())
    for k in list(os.environ):
        if k.startswith("MM_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("MM_CONFIG_JSON", str(path))
    monkeypatch.setenv("MM_DURABILITY_JOURNAL_DIR", str(tmp_path / "j"))
    monkeypatch.setenv("MM_DURABILITY_FSYNC", "window")
    monkeypatch.setenv("MM_OVERLOAD_DRAIN_CHECKPOINT_DIR", "/tmp/d")
    monkeypatch.setenv("MM_AUTH_MODE", "static")
    monkeypatch.setenv("MM_BATCHER_MAX_WAIT_MS", "2.5")
    monkeypatch.setenv("MM_METRICS_PORT", "9123")
    monkeypatch.setenv("MM_METRICS_HOST", "0.0.0.0")
    cfg, jcfg = config.Config.from_env(), jax_config.Config.from_env()
    assert (cfg.metrics_port, cfg.metrics_host) == (
        jcfg.metrics_port, jcfg.metrics_host) == (9123, "0.0.0.0")
    assert cfg.engine.backend == "gpu" and jcfg.engine.backend == "tpu"
    for section in ("durability", "overload", "auth", "batcher"):
        assert dataclasses.asdict(getattr(cfg, section)) == {
            f.name: getattr(getattr(jcfg, section), f.name)
            for f in dataclasses.fields(getattr(cfg, section))}, section
    assert [q.name for q in cfg.queues] == [q.name for q in jcfg.queues]
    monkeypatch.setenv("MM_ENGINE_BACKEND", "cpu")  # the variable wins
    monkeypatch.setenv("MM_QUEUE_NAMES", cfg.queues[1].name)
    cfg = config.Config.from_env()
    assert cfg.engine.backend == "cpu" and len(cfg.queues) == 1
    monkeypatch.setenv("MM_QUEUE_NAMES", "nope")
    with pytest.raises(KeyError):
        config.Config.from_env()
