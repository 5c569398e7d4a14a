"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m mmbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. The last line of standard output is the result object; the numbers
compared with the reference, each beside its limit, are the last lines of
standard error and the result's last key (``checks``). Without enough
CUDA devices, or with JAX or the JAX package loaded once the window has
closed, it exits with another code than 0 and prints no result.

The port's kernel builds go to ``build/`` inside the checkout, at fixed
paths, so only a checkout's first run builds them.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

#: Top-level modules that may not be loaded in the process that prints.
BANNED = ("jax", "jaxlib", "flax", "matchmaking_tpu")


def banned_modules(names) -> list[str]:
    """The banned top-level names among module names, compared whole."""
    return sorted({n.split(".")[0] for n in names} & set(BANNED))


def set_caches(repo) -> None:
    """Every build and kernel cache of the program inside the checkout."""
    build = os.path.join(repo, "build")
    os.environ["MM_KERNEL_BUILD_DIR"] = os.path.join(build, "torch_kernels")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m mmbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from mmbench import manifest
    from mmbench.harness import Cell, run_cell

    set_caches(str(manifest.REPO))
    man = manifest.load()
    w = manifest.workload(man, args.workload)
    marks = [("start", T_PROCESS)]
    import torch

    marks.append(("import_torch", time.perf_counter()))
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"mmbench: {args.workload} needs {w['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    marks.append(("cuda_init", time.perf_counter()))
    entries = manifest.metrics_for(man, args.workload, bool(args.trace))
    cell = Cell(name=args.workload,
                config=manifest.config_file(man, w["config"]),
                traffic=manifest.traffic_file(w["traffic"]),
                metrics=[(m, manifest.reader(m["name"])) for m in entries])
    result, notes = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             marks=marks)
    bad = banned_modules(sys.modules)
    if bad:
        print(f"mmbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print("notes: " + json.dumps(notes), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
