"""The port's twin of `tests/tiny_ian_full.py`: a full-IAN-shaped profile at
1/8 width (encoder 16/32/64/128, decoder 64/64/32/16, 16 latents), loaded by
path through `npe_tpu_torch.models.get_config`. Same layer names and code
paths as `npe_tpu_torch/models/ian.py`, whose apply functions read widths
from the weights; the three MDBLOCKs and the RGB-Beta head run at their full
spatial sizes."""

from npe_tpu_torch.models import common, ian
from npe_tpu_torch.models.common import VarBuilder
from npe_tpu_torch.utils.device import resolve_device

cfg = dict(ian.cfg, model="tiny_ian_full", batch_size=8, batches_per_chunk=2, max_epochs=2, num_latents=16)

NUM_LATENTS = cfg["num_latents"]
N_DISCRIM_CLASSES = 3
HAS_IAF = True
MADE_HIDDEN = [NUM_LATENTS]
WIDTHS = (16, 32, 64, 128)
FC = 64
D = (64, 64, 32, 16)


def init(gen, device="cuda"):
    vb = VarBuilder(gen, resolve_device(device))
    common.init_encoder(vb, NUM_LATENTS, widths=WIDTHS, fc=FC)
    ian.init_iaf_and_decoder(vb, NUM_LATENTS, MADE_HIDDEN, D, cfg["n_shuffles"])
    common.init_discrim(vb, N_DISCRIM_CLASSES, w_std=0.02, feat=WIDTHS[3], n_kernels=32)
    return vb.v


encode_stats = ian.encode_stats
encode_pre_iaf = ian.encode_pre_iaf
encode = ian.encode
iaf = ian.iaf
rgb_beta_head = ian.rgb_beta_head
decode = ian.decode
decode_pre_iaf = ian.decode_pre_iaf
backbone = ian.backbone
discrim_logits = ian.discrim_logits
sample_latent = ian.sample_latent
