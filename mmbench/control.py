"""The control of the comparison that decides ``correct``, at a cell's own
size: the run of the cell, then the reference computed in bfloat16 put in
the program's place and held against the float32 reference, by the same
numbers and limits. The control must fail them; the program must not.

    python3 -m mmbench.control --workload <cell> --seeds <a,b,c> --seconds <s>

prints one JSON line a seed: the program's numbers and the control's,
each beside its limit, and the control's details (``compare.DETAILS``).
The benchmark's own runs do not run it.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m mmbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from mmbench import manifest, run
    from mmbench.harness import Cell, run_cell

    run.set_caches(str(manifest.REPO))
    man = manifest.load()
    w = manifest.workload(man, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("mmbench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = Cell(name=args.workload,
                config=manifest.config_file(man, w["config"]),
                traffic=manifest.traffic_file(w["traffic"]),
                metrics=[])
    for seed in (int(s) for s in args.seeds.split(",")):
        result, notes = run_cell(cell, seed, args.seconds, False,
                                 control=True)
        prog = {k: c["value"] for k, c in result["checks"].items()}
        ctrl = {k: notes["control"][k] for k in prog}
        limits = {k: c["limit"] for k, c in result["checks"].items()}
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "program": prog, "control": ctrl, "limits": limits,
            "program_correct": result["correct"],
            "control_fails": any(ctrl[k] > limits[k] for k in limits),
            "control_details": notes["control"],
            "windows": notes["windows"], "check_s": notes["check_s"]}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
