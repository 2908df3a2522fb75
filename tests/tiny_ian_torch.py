"""The port's twin of `tests/tiny_ian.py`: an IAN_simple-shaped profile at
1/8 width, loaded by path through `npe_tpu_torch.models.get_config`. Same
layer names and code paths as `npe_tpu_torch/models/ian_simple.py`, whose
apply functions read widths from the weights."""

from npe_tpu_torch.models import common, ian_simple
from npe_tpu_torch.models.common import VarBuilder
from npe_tpu_torch.utils.device import resolve_device

cfg = dict(ian_simple.cfg, model="tiny_ian", num_latents=16)

NUM_LATENTS = cfg["num_latents"]
N_DISCRIM_CLASSES = 1
HAS_IAF = False
WIDTHS = (16, 32, 64, 128)
FC = 64


def init(gen, device="cuda"):
    vb = VarBuilder(gen, resolve_device(device))
    common.init_encoder(vb, NUM_LATENTS, widths=WIDTHS, fc=FC)
    vb.dense("l_dec_fc2", NUM_LATENTS, WIDTHS[3] * 16, bias=False)
    vb.bn("bnorm_dec_fc2", WIDTHS[3] * 16)
    vb.deconv("dec_conv1", WIDTHS[3], WIDTHS[2], bias=False)
    vb.bn("bnorm_dc1", WIDTHS[2])
    vb.deconv("dec_conv2", WIDTHS[2], WIDTHS[1], bias=False)
    vb.bn("bnorm_dc2", WIDTHS[1])
    vb.deconv("dec_conv3", WIDTHS[1], WIDTHS[0], bias=False)
    vb.bn("bnorm_dc3", WIDTHS[0])
    vb.deconv("dec_out", WIDTHS[0], 3, bias=False)
    common.init_discrim(vb, 1, w_std=0.01, feat=WIDTHS[3], n_kernels=32)
    return vb.v


encode_stats = ian_simple.encode_stats
encode = ian_simple.encode
decode = ian_simple.decode
iaf = ian_simple.iaf
backbone = ian_simple.backbone
discrim_logits = ian_simple.discrim_logits
sample_latent = ian_simple.sample_latent
encode_pre_iaf = ian_simple.encode_pre_iaf
decode_pre_iaf = ian_simple.decode_pre_iaf
