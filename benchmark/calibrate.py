"""The readings that the limits of `correct` are set from, on the card:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... --seconds <s>
        [--subjects program control half_batch]

For each seed, in one process: the cell's set-up and a window of `seconds`
at its own load, then the numbers its check compares, read for each subject:
"program" (what the run compares), "control" (the plain reference in TF32 in
the program's place) and, for a training cell, "half_batch" (the reference
on half of each batch's rows: the fault of a step that leaves half the batch
out and takes the mean over the rest). One JSON line a seed and subject,
then one line with the largest program reading and the smallest reading of
every other subject, number by number. The benchmark's own runs never run
this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--subjects", nargs="+", default=["program", "control"])
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import core

    if not torch.cuda.is_available():
        print("calibrate.py reads the card's numbers; this process sees no CUDA device", file=sys.stderr)
        return 2
    found = {}
    for seed in args.seeds:
        run = core.Run(args.workload, seed, args.seconds, 0, "cuda")
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(run.config.get("tf32"))
        gen = core.generator(run.traffic["kind"])
        t0 = time.perf_counter()
        gen.setup(run)
        gen.window(run, args.seconds)
        torch.cuda.synchronize()
        gen.release(run)
        torch.cuda.empty_cache()
        for subject in args.subjects:
            r = gen.readings(run, subject)
            found.setdefault(subject, []).append(r)
            print(json.dumps({"seed": seed, "subject": subject, "work": run.work, "readings": r,
                              "seconds": time.perf_counter() - t0}), flush=True)
        del run
        torch.cuda.empty_cache()
    summary = {}
    for subject, rows in found.items():
        pick = max if subject == "program" else min
        summary[subject] = {k: pick(r[k] for r in rows) for k in rows[0] if isinstance(rows[0][k], float)}
    print(json.dumps({"workload": args.workload, "seeds": args.seeds, "device": torch.cuda.get_device_name(0),
                      "largest program, smallest others": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
