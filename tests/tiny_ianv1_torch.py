"""The port's twin of `tests/tiny_ianv1.py`: an IANv1-shaped profile at 1/8
width with 16 latents, loaded by path through
`npe_tpu_torch.models.get_config`. Same layer names and code paths as
`npe_tpu_torch/models/ian_v1.py`, whose apply functions read widths from the
weights; the RGB-Beta head runs at its full 64x64."""

from npe_tpu_torch.models import common, ian_v1
from npe_tpu_torch.models.common import VarBuilder
from npe_tpu_torch.utils.device import resolve_device

cfg = dict(ian_v1.cfg, model="tiny_ianv1", batch_size=8, num_latents=16)

NUM_LATENTS = cfg["num_latents"]
N_DISCRIM_CLASSES = 1
HAS_IAF = True
WIDTHS = (16, 32, 64, 128)
FC = 64
DEC_WIDTHS = (128, 64, 32, 16, 8)


def init(gen, device="cuda"):
    vb = VarBuilder(gen, resolve_device(device))
    common.init_encoder(vb, NUM_LATENTS, widths=WIDTHS, fc=FC)
    ian_v1.init_iaf_and_decoder(vb, NUM_LATENTS, [NUM_LATENTS], DEC_WIDTHS, cfg["n_shuffles"])
    common.init_discrim(vb, 1, w_std=0.01, feat=WIDTHS[3], n_kernels=32)
    return vb.v


encode_stats = ian_v1.encode_stats
encode_pre_iaf = ian_v1.encode_pre_iaf
encode = ian_v1.encode
iaf = ian_v1.iaf
rgb_beta_head = ian_v1.rgb_beta_head
decode = ian_v1.decode
decode_pre_iaf = ian_v1.decode_pre_iaf
backbone = ian_v1.backbone
discrim_logits = ian_v1.discrim_logits
sample_latent = ian_v1.sample_latent
