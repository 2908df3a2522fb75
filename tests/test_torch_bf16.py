"""The bfloat16 inference path of npe_tpu_torch against npe_tpu's, at the tiny
profiles: `utils.cast`, the bf16 plain versions of the three dtype-generic
kernels (`mdblock_fused`, `rgb_beta_head`, `rgb_beta_tail`) against npe_tpu's
references run in bf16, and `api.IAN`, `EditSession` and `InferenceServer` with
`dtype=torch.bfloat16` for IAN_simple, IANv1 (both head forms) and full IAN
(both MDBLOCK forms).

Tolerances, in units of bf16's relative rounding step STEP = 2^-8:

* a kernel's plain version against npe_tpu's reference: both round at the
  same points, but add in other orders, so a float32 sum a hair either side
  of a bf16 rounding boundary rounds to neighbouring bf16 values (one ulp, two
  steps of the value). Each point that rounds can do that once, so an output
  may be off by `points` steps of its own magnitude plus of its spread:
  |a - b| <= points * STEP * (|b| + std(b)). mdblock and the tail round at
  three points (each MDCL's or product's input, then the output); the head at
  four, because npe_tpu composes its 9x9 trunk kernel in bf16 and so rounds
  the sum of the branches' centre taps, which the port's kernel adds in
  float32 from the stacked taps.
* whole paths: the two packages round at different places (XLA fuses an
  elementwise chain in float32 where PyTorch rounds after each op), so the
  port's bf16 result is held to npe_tpu's bf16 result within twice the gap
  that bf16 itself opens against the port's float32 result, in mean abs; and
  the port's bf16 result to its float32 result within npe_tpu's own bounds,
  mean abs < 0.05 on images (tests/test_api_bf16.py) and < 0.2 on Z
  (tests/test_editor.py). npe_tpu's own bf16 results meet those bounds at
  these profiles too, so no looser bound is taken from them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parity as tp
from npe_tpu.api import IAN as JaxIAN
from npe_tpu.editor.engine import EditSession as JaxSession
from npe_tpu.models import common as jcommon
from npe_tpu.ops.pallas import mdcl_kernels as jk
from npe_tpu.utils.cast import cast_floating as jax_cast_floating
from npe_tpu_torch.api import IAN
from npe_tpu_torch.editor.engine import EditSession
from npe_tpu_torch.models import common as tcommon
from npe_tpu_torch.ops.kernels import mdblock as mk
from npe_tpu_torch.ops.kernels import rgb_beta_head as th
from npe_tpu_torch.ops.kernels import rgb_beta_tail as tt
from npe_tpu_torch.serving import InferenceServer
from npe_tpu_torch.utils.cast import cast_floating, resolve_dtype
from npe_tpu_torch.utils.checkpoints import from_reference, to_reference, unit_gain
from npe_tpu_torch.utils.ranges import from_tanh, to_tanh

tp.torch_threads()
STEP = 2.0 ** -8
BF16 = torch.bfloat16
SCALES = [2, 3, 4]
IMAGE_BOUND, Z_BOUND = 0.05, 0.2  # npe_tpu's own bf16 bounds, mean abs
WAIT = 60


def bf16_values(a):
    """float32 numpy values that bf16 holds exactly, so that both packages
    start from the same bf16 inputs."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def assert_within_steps(actual, desired, points):
    a, d = np.asarray(actual, np.float64), np.asarray(desired, np.float64)
    err = np.abs(a - d)
    limit = points * STEP * (np.abs(d) + d.std())
    assert d.std() > 0.05 and (err <= limit).all(), f"{(err > limit).sum()} values off; worst {(err / limit).max():.3f}"


def wide(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(jnp.asarray(t).astype(jnp.float32))


# --- utils/cast.py -------------------------------------------------------------


def test_cast_floating_matches_npe_tpu_bit_for_bit():
    jv = tp.jax_variables(tp.TINY_V1_JAX)  # masks, biases, BN state and MDCL coefficients
    want = jax_cast_floating(jv)
    got = cast_floating(from_reference(jv, "cpu"))
    assert all(t.dtype == BF16 for t in got.values())
    back = to_reference({k: t.float() for k, t in got.items()})
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], np.asarray(want[k].astype(jnp.float32)), err_msg=k)
    # integer and bool tensors untouched, a new dict
    leaves = {"i": torch.arange(3), "b": torch.ones(2, dtype=torch.bool), "f": torch.ones(2, dtype=torch.float64)}
    out = cast_floating(leaves)
    assert out["i"] is leaves["i"] and out["b"] is leaves["b"] and out is not leaves
    assert out["f"].dtype == BF16 and leaves["f"].dtype == torch.float64
    assert cast_floating(leaves, torch.float32)["f"].dtype == torch.float32


@pytest.mark.parametrize("dtype,want", [
    (None, torch.float32), (torch.float32, torch.float32), (np.float32, torch.float32), ("float32", torch.float32),
    (torch.bfloat16, BF16), ("bfloat16", BF16),
])
def test_resolve_dtype_takes_the_two_dtypes(dtype, want):
    assert resolve_dtype(dtype) is want


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, "float16", np.float64])
def test_other_dtypes_raise_at_every_entry_point(dtype):
    for make in (lambda: IAN(tp.TINY_TORCH, device="cpu", dtype=dtype),
                 lambda: EditSession(tp.TINY_TORCH, dim=(4, 4), device="cpu", dtype=dtype),
                 lambda: InferenceServer(config=tp.TINY_TORCH, device="cpu", dtype=dtype)):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            make()


# --- the kernels' plain versions in bf16 against npe_tpu's references -------------


@pytest.mark.parametrize("c,size,scales", [(32, 8, (0, 2)), (16, 16, (0, 2, 3))])
def test_mdblock_plain_version_matches_npe_tpu_in_bf16(c, size, scales):
    """Three rounding points (each MDCL's input, the output); npe_tpu's
    reference (`mdblock_taps_reference`) and its kernel in interpret mode."""
    rng = np.random.RandomState(c)
    n_taps = 9 * (1 + sum(s > 0 for s in scales))
    x = bf16_values(rng.randn(2, size, size, c))
    t1, t2 = (bf16_values(rng.randn(n_taps, c, c) / np.sqrt(2.2 * c)) for _ in range(2))
    aff = np.stack([rng.uniform(0.8, 1.2, c), rng.uniform(-0.2, 0.2, c)] * 3).astype(np.float32)
    args = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(t1, jnp.bfloat16), jnp.asarray(t2, jnp.bfloat16),
            tuple(jnp.asarray(a) for a in aff), jk.tap_offsets(scales))
    got = mk.mdblock_taps_reference(tp.nchw(x).to(BF16), torch.from_numpy(t1).to(BF16),
                                    torch.from_numpy(t2).to(BF16), torch.from_numpy(aff), scales)
    assert got.dtype == BF16
    for want in (jk.mdblock_taps_reference(*args), jk.mdblock_fused(*args, 2, True)):
        assert want.dtype == jnp.bfloat16
        assert_within_steps(tp.nhwc(got.float()), wide(want), 3)
    # the wrapper on CPU tensors is that plain version, and counts no launch
    before = (mk.mdblock_fused.launches, mk.mdblock_fused.launches_bf16)
    assert torch.equal(mk.mdblock_fused(tp.nchw(x).to(BF16), torch.from_numpy(t1).to(BF16),
                                        torch.from_numpy(t2).to(BF16), torch.from_numpy(aff), scales), got)
    assert (mk.mdblock_fused.launches, mk.mdblock_fused.launches_bf16) == before


def test_tail_plain_version_matches_npe_tpu_in_bf16():
    """Three rounding points (R, then [R, G], before their products; the
    output); npe_tpu's reference and its kernel in interpret mode. A float32
    trunk with bf16 taps is the fused head's case."""
    rng = np.random.RandomState(1)
    trunk = bf16_values(rng.randn(2, 16, 16, 96))
    tg, tb = bf16_values(rng.randn(9, 32, 32) * 0.1), bf16_values(rng.randn(9, 64, 32) * 0.07)
    jargs = tuple(jnp.asarray(a, jnp.bfloat16) for a in (trunk, tg, tb))
    targs = (tp.nchw(trunk).to(BF16), torch.from_numpy(tg).to(BF16), torch.from_numpy(tb).to(BF16))
    got = tt.rgb_beta_tail_reference(*targs)
    assert got.dtype == BF16
    for want in (jk.rgb_beta_tail_reference(*jargs, 16), jk.rgb_beta_tail_pallas(*jargs, 16, 8, True)):
        assert want.dtype == jnp.bfloat16
        assert_within_steps(tp.nhwc(got.float()), wide(want), 3)
    before = (tt.rgb_beta_tail.launches, tt.rgb_beta_tail.launches_bf16)
    assert torch.equal(tt.rgb_beta_tail(*targs), got)
    assert (tt.rgb_beta_tail.launches, tt.rgb_beta_tail.launches_bf16) == before
    # the same bf16 trunk as float32 gives the same sums
    assert torch.equal(tt.rgb_beta_tail_reference(targs[0].float(), *targs[1:]), got)


def test_head_plain_version_matches_the_pallas_kernel_in_bf16():
    """The fused form's plain version over the stacked taps of bf16 weights
    against npe_tpu's Pallas head in interpret mode over its composed bf16
    kernels: four rounding points (module docstring)."""
    vb = jcommon.VarBuilder(jax.random.PRNGKey(3))
    for name, cin in (("R", 8), ("G_a", 8), ("G_b", 2), ("B_a", 8), ("B_b", 4)):
        vb.mdcl(name, cin, 2, SCALES)
    jv = unit_gain(vb.v)
    rng = np.random.RandomState(3)
    jv = {k: bf16_values(v * rng.uniform(0.5, 1.5, v.shape) if "_coeff_" in k else v) for k, v in jv.items()}
    jvb = jax_cast_floating(jv)
    h = bf16_values(rng.randn(2, 64, 64, 8) * 0.5)
    k_trunk = jnp.concatenate([jcommon._composed_mdcl_kernel(jvb, n, SCALES) for n in ("R", "G_a", "B_a")], -1)
    k_g, k_b = (jcommon._composed_mdcl_kernel(jvb, n, SCALES) for n in ("G_b", "B_b"))
    want = jk.rgb_beta_head_pallas(jnp.asarray(h, jnp.bfloat16), k_trunk, k_g, k_b, 4, 1, True)
    taps = tcommon.packed_head_weights(cast_floating(from_reference(jv, "cpu")), SCALES, 4, as_taps=True)
    assert all(t.dtype == BF16 for t in taps) and want.dtype == jnp.bfloat16
    got = th.rgb_beta_head_reference(tp.nchw(h).to(BF16), *taps, SCALES)
    assert got.dtype == BF16
    assert_within_steps(tp.nhwc(got.float()), wide(want), 4)
    before = (th.rgb_beta_head.launches, th.rgb_beta_head.launches_bf16)
    assert torch.equal(th.rgb_beta_head(tp.nchw(h).to(BF16), *taps, SCALES), got)
    assert (th.rgb_beta_head.launches, th.rgb_beta_head.launches_bf16) == before


@pytest.mark.parametrize("kernel", ["tail", "head", "mdblock"])
def test_mixed_dtype_kernel_calls_raise(kernel):
    """All activations and taps in one dtype, float32 or bf16; the MDBLOCK's
    affines float32: anything else raises before any launch, never casts."""
    if kernel == "tail":
        args = [torch.zeros(1, 96, 16, 16), torch.zeros(9, 32, 32), torch.zeros(9, 64, 32)]
        call, casts = tt.rgb_beta_tail, [(0,), (1,), (2,), (1, 2)]
    elif kernel == "head":
        args = [torch.zeros(1, 8, 64, 64), torch.zeros(36, 8, 6), torch.zeros(9, 32, 32), torch.zeros(9, 64, 32)]
        call, casts = (lambda *a: th.rgb_beta_head(*a, SCALES)), [(0,), (1,), (2, 3), (1, 2, 3)]
    else:
        args = [torch.zeros(1, 16, 8, 8), torch.zeros(18, 16, 16), torch.zeros(18, 16, 16), torch.zeros(6, 16)]
        call, casts = (lambda *a: mk.mdblock_fused(*a, (0, 2))), [(0,), (1,), (0, 1), (0, 1, 2, 3)]
    for which in casts:
        bad = [a.to(BF16) if i in which else a for i, a in enumerate(args)]
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            call(*bad)
    assert call(*args).dtype == torch.float32
    good = [a.to(BF16) if kernel != "mdblock" or i < 3 else a for i, a in enumerate(args)]
    assert call(*good).dtype == BF16
    with pytest.raises(TypeError, match="float32"):
        call(*[a.half() for a in args])
    if kernel == "tail":  # the bf16 form over a float32 trunk: the fused head's, and tail_only's on the card
        with pytest.raises(TypeError, match="float32 trunk"):
            tt.tail_only(*args)
        with pytest.raises(ValueError, match="CUDA"):
            tt.tail_only(args[0], *good[1:])


# --- whole paths: api.IAN, EditSession, InferenceServer ---------------------------

# (npe_tpu config, port config, the port's form)
FORMS = [(tp.TINY_JAX, tp.TINY_TORCH, {}),
         (tp.TINY_V1_JAX, tp.TINY_V1_TORCH, {"head_mode": "hybrid"}),
         (tp.TINY_V1_JAX, tp.TINY_V1_TORCH, {"head_mode": "fused"}),
         (tp.TINY_FULL_JAX, tp.TINY_FULL_TORCH, {"mdblock_mode": "plain"}),
         (tp.TINY_FULL_JAX, tp.TINY_FULL_TORCH, {"mdblock_mode": "fused"})]
IDS = ["IAN_simple", "IANv1-hybrid", "IANv1-fused", "IAN-plain", "IAN-fused"]
STROKES = [(10, 10, 20, 20, (255, 0, 0), 0.5), (30, 5, 50, 25, (0, 255, 0), 0.0)]
_jax_results = {}


def _inputs():
    rng = np.random.RandomState(0)
    x = (rng.uniform(-1, 1, (3, 3, 64, 64)) * 0.8).astype(np.float32)
    z = rng.randn(3, 16).astype(np.float32)
    image = ((rng.rand(3, 64, 64) * 2 - 1) * 0.5).astype(np.float32)
    return x, z, image


def _variables(jax_config):
    return tp.with_bn_state(tp.jax_variables(jax_config), seed=5)


def _run_session(session, image):
    session.infer(image)
    z_inferred = np.array(session.Z, np.float32)
    for stroke in STROKES:
        session.paint_stroke(*stroke)
    return z_inferred, np.array(session.Z, np.float32), np.array(session.IM)


def jax_bf16(jax_config):
    """npe_tpu in bf16 on the same weights, once a model: encode_images,
    sample_at and a session's state after infer and two strokes."""
    if jax_config not in _jax_results:
        x, z, image = _inputs()
        jv = tp.as_jax(_variables(jax_config))
        api = JaxIAN(config_path=jax_config, variables=jv, dtype=jnp.bfloat16)
        session = JaxSession(config=jax_config, variables=jv, dim=(4, 4), use_pallas=False, dtype=jnp.bfloat16)
        _jax_results[jax_config] = {"encode": api.encode_images(x), "decode": api.sample_at(z),
                                    "session": _run_session(session, image)}
    return _jax_results[jax_config]


def assert_mean_close(label, port16, jax16, port32, bound):
    """The module docstring's two rules for a whole path's output."""
    own = np.abs(port16 - port32).mean()
    assert own < bound, f"{label}: bf16 against float32 {own:.4f}, npe_tpu's bound {bound}"
    gap = np.abs(port16 - jax16).mean()
    assert gap <= 2 * own, f"{label}: port against npe_tpu in bf16 {gap:.5f}, twice bf16's own gap {2 * own:.5f}"


@pytest.mark.parametrize("jax_config,config,form", FORMS, ids=IDS)
def test_api_in_bf16(jax_config, config, form):
    x, z, _ = _inputs()
    tv = from_reference(_variables(jax_config), "cpu")
    m16 = IAN(config, variables=tv, device="cpu", dtype=torch.bfloat16, **form)
    m32 = IAN(config, variables=tv, device="cpu", **form)
    assert all(t.dtype == BF16 for t in m16.variables.values()) and m32.variables is tv
    want = jax_bf16(jax_config)
    got = {"encode": m16.encode_images(x), "decode": m16.sample_at(z)}
    for op, ref32 in (("encode", m32.encode_images(x)), ("decode", m32.sample_at(z))):
        assert got[op].dtype == np.float32 and np.isfinite(got[op]).all()
        assert_mean_close(op, got[op], want[op], ref32, Z_BOUND if op == "encode" else IMAGE_BOUND)
    assert got["decode"].std() > 0.1
    # the gradient of the float32 z through the bf16 decode
    g16, g32 = m16.imgradRGB(8, 8, 24, 24, np.full((1, 3, 64, 64), 0.3, np.float32), z[:1]), \
        m32.imgradRGB(8, 8, 24, 24, np.full((1, 3, 64, 64), 0.3, np.float32), z[:1])
    assert g16.dtype == np.float32 and np.abs(g32).max() > 1e-3
    cosine = float((g16 * g32).sum() / np.linalg.norm(g16) / np.linalg.norm(g32))
    assert cosine > 0.95, cosine


@pytest.mark.parametrize("jax_config,config,form", FORMS, ids=IDS)
def test_session_in_bf16(jax_config, config, form):
    """infer and two strokes: Z, RECON, DELTA and IM float32; the decode and
    its gradient in bf16."""
    _, _, image = _inputs()
    tv = from_reference(_variables(jax_config), "cpu")
    s16 = EditSession(config, variables=tv, dim=(4, 4), device="cpu", dtype="bfloat16", **form)
    s32 = EditSession(config, variables=tv, dim=(4, 4), device="cpu", **form)
    got, ref32, want = _run_session(s16, image), _run_session(s32, image), jax_bf16(jax_config)["session"]
    for label, i, bound in (("inferred Z", 0, Z_BOUND), ("Z after the strokes", 1, Z_BOUND), ("IM", 2, IMAGE_BOUND)):
        assert got[i].dtype == np.float32 and np.isfinite(got[i]).all()
        assert_mean_close(label, got[i], want[i], ref32[i], bound)
    assert np.abs(got[1] - got[0]).max() > 1e-2  # the strokes moved Z
    assert s16.Z.dtype == s16._recon.dtype == s16._error.dtype == torch.float32
    assert s16.RECON.dtype == s16.DELTA.dtype == np.float32
    fork = s16.fork()
    assert fork.dtype is BF16 and fork.variables is s16.variables


@pytest.mark.parametrize("jax_config,config,form", FORMS, ids=IDS)
def test_server_in_bf16(jax_config, config, form):
    """A bf16 server's decodes on both wires: the float32 wire as api.IAN's
    bf16 path (npe_tpu's server runs the same function), the uint8 wire that
    quantised, within one uint8 step."""
    _, z, _ = _inputs()
    tv = from_reference(_variables(jax_config), "cpu")
    want32 = IAN(config, variables=tv, device="cpu", **form).sample_at(z).transpose(0, 2, 3, 1)
    want16 = jax_bf16(jax_config)["decode"].transpose(0, 2, 3, 1)
    out = {}
    for wire in ("float32", "uint8"):
        s = InferenceServer(config=config, variables=tv, max_batch=2, linger_ms=5.0, device="cpu",
                            dtype=torch.bfloat16, wire=wire, **form)
        try:
            out[wire] = np.concatenate([f.result(timeout=WAIT) for f in [s.decode(z[i:i + 1]) for i in range(3)]])
            zx = s.encode(want32[:1]).result(timeout=WAIT)
        finally:
            s.close()
        assert out[wire].dtype == zx.dtype == np.float32 and out[wire].shape == (3, 64, 64, 3)
    assert_mean_close("served decode", out["float32"], want16, want32, IMAGE_BOUND)
    quantised = to_tanh(np.clip(np.round(from_tanh(out["float32"])), 0, 255))
    assert np.abs(out["uint8"] - quantised).max() <= tp.UINT8_STEP + 1e-6
