"""Tiny profiles of the benchmark's configurations for CPU tests: every
width an eighth (the MDBLOCKs' channels stay multiples of 16, the minibatch
layer 50 kernels), depth, latents and shapes as published."""

import copy


def tiny(cfg, k=8):
    t = copy.deepcopy(cfg)
    t["encoder"]["widths"] = [w // k for w in cfg["encoder"]["widths"]]
    t["encoder"]["fc"] = cfg["encoder"]["fc"] // k
    t["decoder"]["fc_channels"] = cfg["decoder"]["fc_channels"] // k
    t["decoder"]["widths"] = [w // k for w in cfg["decoder"]["widths"]]
    if "last_width" in cfg["decoder"]:
        t["decoder"]["last_width"] = cfg["decoder"]["last_width"] // k
    t["discriminator"]["minibatch_kernels"] = cfg["discriminator"]["minibatch_kernels"] // 10
    return t
