"""Sampling / eval entry point (npe_tpu `training/sample.py`, reference
`sample_IAN.py`).

The four inference functions -- `sample` (decode from a pre-IAF latent),
`sampleZ` (decode from a post-IAF latent), `Zfn` (encode to pre-IAF),
`Z_IAF_fn` (the flow alone) (`sample_IAN.py:86-94`), captured programs on
the card -- and a CLI that loads weights and writes the 6x9
sample/interpolation grid to pics/<model>_sample<epoch>.png (a PNG from
`utils/png.py`; no PIL) through the same programs.

CLI: python -m npe_tpu_torch.training.sample IAN_simple --epoch 10
"""

import argparse
import os

import torch

from npe_tpu_torch.data import get_dataset
from npe_tpu_torch.models import get_config
from npe_tpu_torch.training.eval_grids import sample_and_interp_grid
from npe_tpu_torch.training.programs import EvalPrograms, device_of
from npe_tpu_torch.utils import checkpoints
from npe_tpu_torch.utils.device import resolve_device


def make_inference_functions(module):
    """The reference's tfuncs dict (`sample_IAN.py:86-100`): functions of
    (variables, tensor) that return a tensor on the variables' device, run as
    one owner's programs (`training/programs.py`, npe_tpu's jitted
    functions), the owner made by the first call on that call's device. Each
    call loads the variables it is given, then runs its program."""
    owner = []

    def program(name):
        def run(v, t):
            if not owner:
                owner.append(EvalPrograms(module, device_of(v)))
            owner[0].load(v)
            return owner[0](name, t)

        return run

    return {"sample": program("decode_pre_iaf"), "sampleZ": program("decode"), "Zfn": program("encode_pre_iaf"),
            "Z_IAF_fn": program("iaf")}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("config_path")
    p.add_argument("--epoch", type=int, default=0)
    p.add_argument("--weights", default=None)
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="'cuda' (the default; raises without one) or 'cpu'")
    a = p.parse_args(argv)

    device = resolve_device(a.device)
    module = get_config(a.config_path)
    name = module.cfg["model"]
    variables = module.init(torch.Generator().manual_seed(0), device)
    weights = a.weights or (name + ".npz")
    if os.path.isfile(weights):
        checkpoints.load_weights(weights, variables)
    dataset = get_dataset(a.dataset)
    os.makedirs("pics", exist_ok=True)
    out = f"pics/{name}_sample{a.epoch}.png"
    sample_and_interp_grid(module, variables, dataset, out, seed=a.seed,
                           programs=EvalPrograms.of(module, variables))
    print("wrote", out)
    return out


if __name__ == "__main__":
    main()
