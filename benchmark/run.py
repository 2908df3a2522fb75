"""Run one cell of the port's benchmark once, on the card this process sees:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output,
one JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones), `device`, with
--trace 1 `breakdown`, and last `checks`, each number compared with its
limit; the same numbers go to standard error as its last lines. Exits 2
without a result when CUDA is not available or the cell wants more cards
than there are, and 1 when the run fails or loads JAX or the JAX package.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache the run writes stays inside the checkout, at a fixed path
# (the program builds its kernels into npe_tpu_torch/_build/ of the checkout)
CACHE = ROOT / "benchmark_cache"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import core

    run = core.Run(args.workload, args.seed, args.seconds, args.trace, "cuda")
    if not torch.cuda.is_available() or torch.cuda.device_count() < run.workload["chips"]:
        print(f"{args.workload} needs {run.workload['chips']} CUDA device(s); "
              f"this process sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = core.execute(run, STARTED)
    found = core.forbidden_modules()
    if found:
        print(f"the run loaded {found}; the benchmark measures the port alone", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']:.6e} (limit {c['limit']:.6e})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
