"""The RGB-Beta head's backward kernels on the CPU: the tail's
(`npe_rgb_beta_tail_bwd[_bf16]`, npe_tpu's `_tail_bwd`) and x's gradient of
the fused head (`npe_rgb_beta_head_bwd[_bf16]`, npe_tpu's `_head_bwd` for
x). Their plain versions `rgb_beta_tail_backward_reference` and
`rgb_beta_head_backward_reference` against torch's VJP of the plain forwards
and against npe_tpu's custom VJPs (its Pallas kernels in interpret mode), the
bf16 rounding points, the backward's shared memory, and the autograd wiring
of `_Tail` and `_Head` with the plain versions standing in for the launches,
through one tiny IANv1 G + D pair against npe_tpu's (the kernels themselves
run only on the card: chip_smoke.py phases 3 and 3b, tests/test_torch_cuda.py).

Tolerances: float64 to 1e-7 of the largest value (the same sums in another
order); float32 against npe_tpu at rtol 1e-3 / atol 1e-4 (the golden
tolerance); bf16 in bf16 steps (2^-8) of |want| + std, as chip_smoke.py's
`within_steps`."""

import gc
import threading
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_parity as tp
from npe_tpu.ops.pallas import mdcl_kernels as jk
from npe_tpu_torch.models import common as tcommon
from npe_tpu_torch.models import get_config
from npe_tpu_torch.ops.kernels import rgb_beta_head as th
from npe_tpu_torch.ops.kernels import rgb_beta_tail as tt
from npe_tpu_torch.ops.kernels import tallying
from npe_tpu_torch.training import train_step as TTS
from npe_tpu_torch.utils import checkpoints as tckpt
from test_torch_rgb_beta import SCALES, _dense_kernels, _head_variables

tp.torch_threads()

RR = 16
BF16 = torch.bfloat16
# bf16 steps of |want| + std between a backward reference and the bf16 VJP:
# chip_smoke.py's rule for a bf16 gradient (BF16_POINTS + 1)
BF16_BACKWARD_STEPS = 4


def _tail_inputs(n, seed, cells=(16, 16), dtype=torch.float64):
    """trunk (O(1) pre-activations), the tail's taps at unit gain and a
    cotangent g, from numpy; in float64, or float32 cast to `dtype`."""
    rng = np.random.RandomState(seed)
    trunk = rng.randn(n, 6 * RR, *cells)
    tg = rng.randn(9, 2 * RR, 2 * RR) / np.sqrt(9 * 2 * RR / 4)
    tb = rng.randn(9, 4 * RR, 2 * RR) / np.sqrt(9 * 4 * RR / 4)
    g = rng.randn(n, 3 * RR, *cells)
    if dtype == torch.float64:
        return [torch.from_numpy(a) for a in (trunk, tg, tb, g)]
    return [torch.from_numpy(a.astype(np.float32)).to(dtype) for a in (trunk, tg, tb, g)]


def _head_inputs(n, c, seed, dtype=torch.float64, height=32):
    """x (N, C, H, 64), stacked trunk taps for SCALES at unit gain, the
    tail's taps and the image's cotangent g."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, c, height, 64)
    taps = rng.randn(36, c, 6) / np.sqrt(33 * c)
    tg = rng.randn(9, 2 * RR, 2 * RR) / np.sqrt(9 * 2 * RR / 4)
    tb = rng.randn(9, 4 * RR, 2 * RR) / np.sqrt(9 * 4 * RR / 4)
    g = rng.randn(n, 3, height, 64)
    if dtype == torch.float64:
        return [torch.from_numpy(a) for a in (x, taps, tg, tb, g)]
    return [torch.from_numpy(a.astype(np.float32)).to(dtype) for a in (x, taps, tg, tb, g)]


def _tail_vjp(trunk, tg, tb, g):
    leaves = [t.clone().requires_grad_(True) for t in (trunk, tg, tb)]
    return torch.autograd.grad(tt.rgb_beta_tail_reference(*leaves), leaves, g)


def _head_vjp(x, taps, tg, tb, g):
    xl = x.clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(th.rgb_beta_head_reference(xl, taps, tg, tb, SCALES), xl, g)
    return dx


def _head_reference(x, taps, tg, tb, g):
    return th.rgb_beta_head_backward_reference(g, th.trunk_reference(x, taps, SCALES), taps, tg, tb, SCALES)


def _within_bf16_steps(got, want, steps):
    """Every element within `steps` bf16 steps (2^-8) of |want| + std(want);
    returns the worst fraction of that limit."""
    g, w = got.double(), want.double()
    limit = steps * 2.0 ** -8 * (w.abs() + w.std())
    worst = float(((g - w).abs() / limit).max())
    assert worst <= 1.0, worst
    return worst


@pytest.mark.parametrize("cells", [(16, 16), (6, 5), (2, 16)])
def test_the_tail_backward_reference_is_the_vjp_of_the_plain_version_in_float64(cells):
    trunk, tg, tb, g = _tail_inputs(2, 1, cells)
    want = _tail_vjp(trunk, tg, tb, g)
    got = tt.rgb_beta_tail_backward_reference(g, trunk, tg, tb)
    for name, a, b in zip(("dtrunk", "dtg", "dtb"), got, want):
        assert a.dtype == torch.float64 and float(b.abs().max()) > 0.5, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-7, atol=1e-7 * float(b.abs().max()), err_msg=name)


@pytest.mark.parametrize("c", [8, 5])
def test_the_head_backward_reference_is_the_vjp_of_the_plain_version_in_float64(c):
    x, taps, tg, tb, g = _head_inputs(2, c, 2)
    want = _head_vjp(x, taps, tg, tb, g)
    got = _head_reference(x, taps, tg, tb, g)
    assert got.shape == x.shape and float(want.abs().max()) > 0.1
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-7, atol=1e-7 * float(want.abs().max()))


def test_the_transposed_tap_product_is_the_adjoint_and_tap_grad_its_taps_gradient():
    """<tap_conv(h, W), u> = <h, tap_conv_transposed(u, W)> in float64 with
    in != out, and `tap_grad` is the gradient of that product in W."""
    rng = np.random.RandomState(3)
    h, u = torch.from_numpy(rng.randn(2, 6, 5, 7)), torch.from_numpy(rng.randn(2, 4, 5, 7))
    w = torch.from_numpy(rng.randn(9, 6, 4)).requires_grad_(True)
    fwd = tt.tap_conv(h, w)
    lhs, rhs = float((fwd.detach() * u).sum()), float((h * tt.tap_conv_transposed(u, w.detach())).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs) and abs(lhs) > 1.0
    (dw,) = torch.autograd.grad(fwd, w, u)
    np.testing.assert_allclose(tt.tap_grad(h, u).numpy(), dw.numpy(), rtol=1e-12, atol=1e-12)


def test_the_tail_backward_matches_npe_tpus_custom_vjp():
    """jax.vjp of npe_tpu's `rgb_beta_tail_pallas` (interpret mode forward,
    `_tail_bwd` backward) on the same numpy inputs: the trunk's cotangent
    in npe_tpu's NHWC layout, the taps' as they are (the same component-major
    tap matrices)."""
    trunk, tg, tb, g = (t.numpy() for t in _tail_inputs(2, 4, dtype=torch.float32))
    _, vjp = jax.vjp(lambda t, kg, kb: jk.rgb_beta_tail_pallas(t, kg, kb, RR, 8, True),
                     jnp.asarray(tp.nhwc(torch.from_numpy(trunk))), jnp.asarray(tg), jnp.asarray(tb))
    want = [np.asarray(a) for a in vjp(jnp.asarray(tp.nhwc(torch.from_numpy(g))))]
    got = tt.rgb_beta_tail_backward_reference(*(torch.from_numpy(a) for a in (g, trunk, tg, tb)))
    assert all(a.dtype == torch.float32 for a in got)
    for name, a, b in zip(("dtrunk", "dtg", "dtb"), (tp.nhwc(got[0]), got[1].numpy(), got[2].numpy()), want):
        assert np.abs(b).max() > 0.5, name
        tp.assert_close(a, b)


@pytest.mark.parametrize("c", [16, 8])
def test_the_head_x_gradient_matches_npe_tpus_custom_vjp(c):
    """jax.vjp of npe_tpu's `rgb_beta_head_pallas` (`_head_bwd`) for x, from
    the same seeded weights (its dense composed kernels; the port's stacked
    taps) and cotangent."""
    jv, tv = _head_variables(c, seed=5)
    h = (np.random.RandomState(6).randn(1, 64, 64, c) * 0.5).astype(np.float32)
    g = np.random.RandomState(7).randn(1, 64, 64, 3).astype(np.float32)
    dense = _dense_kernels(jv)
    _, vjp = jax.vjp(lambda x: jk.rgb_beta_head_pallas(x, *dense, 4, 1, True), jnp.asarray(h))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    taps = tcommon.packed_head_weights(tv, SCALES, 4, as_taps=True)
    got = _head_reference(tp.nchw(h), *taps, tp.nchw(g))
    assert np.abs(want).max() > 1e-2
    tp.assert_close(tp.nhwc(got), want)


@pytest.mark.parametrize("trunk_dtype", [BF16, torch.float32])
def test_the_bf16_tail_vjp_rounds_where_the_backward_reference_says(trunk_dtype):
    """torch's VJP of the bf16 plain version and the reference written out
    round at the same points: within one bf16 step of each other (a float32
    sum a hair either side of a rounding boundary), well inside the 4-step
    rule the kernels are held to. dtrunk comes back in the trunk's dtype (bf16
    under the hybrid head, float32 under the fused head), dtg and dtb in bf16."""
    trunk, tg, tb, g = _tail_inputs(2, 8, dtype=torch.float32)
    trunk = trunk.to(trunk_dtype)
    tg, tb, g = tg.to(BF16), tb.to(BF16), g.to(BF16)
    want = _tail_vjp(trunk, tg, tb, g)
    got = tt.rgb_beta_tail_backward_reference(g, trunk, tg, tb)
    assert [a.dtype for a in got] == [b.dtype for b in want] == [trunk_dtype, BF16, BF16]
    for a, b in zip(got, want):
        _within_bf16_steps(a, b, 1)


def test_the_bf16_head_x_gradient_is_within_its_stated_steps_of_the_bf16_vjp():
    x, taps, tg, tb, g = _head_inputs(2, 16, 9, dtype=BF16)
    want = _head_vjp(x, taps, tg, tb, g)
    got = _head_reference(x, taps, tg, tb, g)
    assert got.dtype == want.dtype == BF16 and th.trunk_reference(x, taps, SCALES).dtype == torch.float32
    _within_bf16_steps(got, want, BF16_BACKWARD_STEPS)


def test_the_backward_fits_its_blocks_wherever_the_forward_does():
    """The backward runs on the forward's row groups (`tail_rows`): its
    largest pass holds less shared memory than the forward's block at every
    width the forward takes and every batch."""
    for w in range(1, 78):
        for batch in (1, 2, 9, 16, 128, 500):
            for h in (2, 6, 16, 32):
                rows = tt.tail_rows(batch, h, w, 132)
                assert tt.tail_bwd_smem_bytes(w, rows) <= tt.tail_smem_bytes(w, rows) <= tt.SMEM_LIMIT, (w, batch, h)
    assert tt.tail_bwd_smem_bytes(16, 16) == (9 * 64 * 36 + 64 * 18 * 18) * 4  # the B product's pass


# --- the wrappers' autograd wiring, the plain versions standing in for the launches


def _fake_tail_bwd(g, trunk, tg, tb, need_trunk=True, need_taps=True):
    """What `rgb_beta_tail._launch_bwd` returns, from the plain version."""
    _fake_tail_bwd.calls.append((need_trunk, need_taps))
    return tt.rgb_beta_tail_backward_reference(g, trunk, tg, tb, (need_trunk, need_taps, need_taps))


def _fake_head(x, taps, tg, tb, scales):
    return th.rgb_beta_head_reference(x, taps, tg, tb, scales), th.trunk_reference(x, taps, scales)


def _fake_head_bwd(g, x, trunk, taps, tg, tb, scales):
    return th.rgb_beta_head_backward_reference(g, trunk, taps, tg, tb, scales)


@pytest.fixture
def plain_launches(monkeypatch):
    _fake_tail_bwd.calls = []
    monkeypatch.setattr(tt, "_launch", tt.rgb_beta_tail_reference)
    monkeypatch.setattr(tt, "_launch_bwd", _fake_tail_bwd)
    monkeypatch.setattr(th, "_launch", _fake_head)
    monkeypatch.setattr(th, "_launch_bwd", _fake_head_bwd)
    return _fake_tail_bwd.calls


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_the_tail_gets_the_backward_and_only_the_gradients_asked_for(plain_launches, dtype):
    """Through `_Tail`: the trunk's and the taps' gradients are the
    backward's (one call counted in `launches_bwd` / `launches_bwd_bf16`),
    the taps' computed only when one of them is asked for; the gradients not
    asked for are None."""
    trunk, tg, tb, g = _tail_inputs(2, 10, dtype=dtype)
    attr = "launches_bwd_bf16" if dtype == BF16 else "launches_bwd"
    want = tt.rgb_beta_tail_backward_reference(g, trunk, tg, tb)
    for asked, flags in (((0, 1, 2), (True, True)), ((0,), (True, False)), ((1,), (False, True)),
                         ((2,), (False, True)), ((1, 2), (False, True))):
        leaves = [t.clone().requires_grad_(i in asked) for i, t in enumerate((trunk, tg, tb))]
        before = getattr(tt.rgb_beta_tail, attr)
        got = torch.autograd.grad(tt._Tail.apply(*leaves), [leaves[i] for i in asked], g)
        assert getattr(tt.rgb_beta_tail, attr) == before + 1 and plain_launches[-1] == flags, asked
        for i, a in zip(asked, got):
            assert torch.equal(a, want[i]), (asked, i)
    assert len(plain_launches) == 5


def test_the_head_x_gets_the_backward_and_the_taps_the_plain_vjp(plain_launches):
    """Through `_Head`: x's gradient is the backward's (counted in
    `launches_bwd`), the taps' the plain version's VJP with x's flag off;
    each asked for alone gets only its own."""
    x, taps, tg, tb, g = _head_inputs(2, 8, 11, dtype=torch.float32, height=16)
    leaves = [t.clone().requires_grad_(True) for t in (x, taps, tg, tb)]
    before = th.rgb_beta_head.launches_bwd
    got = torch.autograd.grad(th._Head.apply(*leaves, SCALES), leaves, g)
    assert th.rgb_beta_head.launches_bwd == before + 1
    want = torch.autograd.grad(th.rgb_beta_head_reference(*leaves, SCALES), leaves, g)
    assert torch.equal(got[0], _head_reference(x, taps, tg, tb, g))
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
    (only_taps,) = torch.autograd.grad(th._Head.apply(x, leaves[1], tg, tb, SCALES), leaves[1], g)
    assert torch.equal(only_taps, want[1]) and th.rgb_beta_head.launches_bwd == before + 1
    assert not plain_launches  # the head's backward runs the tail's passes inside its own launch


def test_the_head_forward_keeps_the_trunk_only_when_x_will_need_a_gradient(plain_launches, monkeypatch):
    """With grad on and x requiring it the forward keeps its float32 trunk;
    under no_grad and inference_mode no node is made and the trunk is gone
    once the call returns; with only the taps requiring a gradient it is not
    kept."""
    x, taps, tg, tb, _ = _head_inputs(1, 4, 12, dtype=torch.float32, height=8)
    made = []

    def forward(*args):
        out, trunk = _fake_head(*args)
        made.append(weakref.ref(trunk))
        return out, trunk

    monkeypatch.setattr(th, "_launch", forward)
    xg = x.clone().requires_grad_(True)
    for mode in (torch.no_grad, torch.inference_mode):
        with mode():
            out = th._Head.apply(xg, taps, tg, tb, SCALES)
        gc.collect()
        assert out.grad_fn is None and made[-1]() is None, mode
    out = th._Head.apply(xg, taps, tg, tb, SCALES)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5 and torch.equal(saved[4], th.trunk_reference(x, taps, SCALES))
    assert saved[4].dtype == torch.float32 and made[-1]() is not None
    out = th._Head.apply(x, taps.clone().requires_grad_(True), tg, tb, SCALES)
    assert len(out.grad_fn.saved_tensors) == 4


@pytest.mark.parametrize("which", ["tail", "head"])
def test_a_backward_on_another_thread_counts_in_its_forwards_tally(plain_launches, which):
    """autograd may run a CUDA backward on a thread of its own: its call
    counts in the tally of the thread that ran the forward (a capture takes
    back what its own thread counted), not in that other thread's."""
    if which == "tail":
        trunk, tg, tb, g = _tail_inputs(1, 13, dtype=torch.float32)
        leaf, fn = trunk.requires_grad_(True), tt.rgb_beta_tail

        def forward():
            return tt._Tail.apply(leaf, tg, tb)
    else:
        x, taps, tg, tb, g = _head_inputs(1, 4, 13, dtype=torch.float32, height=8)
        leaf, fn = x.requires_grad_(True), th.rgb_beta_head

        def forward():
            return th._Head.apply(leaf, taps, tg, tb, SCALES)

    with tallying() as tally:
        out = forward()
        other = {}

        def backward():
            with tallying() as own:
                torch.autograd.grad(out, leaf, g)
            other.update(own)

        worker = threading.Thread(target=backward)
        worker.start()
        worker.join()
    assert tally == {(fn, "launches"): 1, (fn, "launches_bwd"): 1}
    assert other == {}


def test_a_tiny_ianv1_g_and_d_pair_through_the_tail_wiring_matches_npe_tpu_in_float64(plain_launches, monkeypatch):
    """The slice as a whole: one G and one D step of the tiny IANv1 from
    npe_tpu's state, the hybrid head's tail routed through `_Tail` (the
    launches' plain versions, float64), against npe_tpu's `make_train_steps`
    pair under x64. A G step decodes twice and takes both decodes' tail
    gradients, the taps' included; the D step's latent gradient goes back
    through the reconstruction's decode alone, for the trunk's gradient: three
    backward calls a pair, the taps' in two."""
    from test_torch_training import LR, _torch_batch, jax_steps

    monkeypatch.setattr(tcommon, "rgb_beta_tail", lambda trunk, tg, tb: tt._Tail.apply(trunk, tg, tb))
    (x, z, eps), state0_np, after = jax_steps("IANv1", "float64")
    tm = get_config(tp.TINY_V1_TORCH)
    state0 = tckpt.train_state_from_reference(state0_np, "cpu")
    gen_step, discrim_step = TTS.make_train_steps(tm, dict(tm.cfg))
    batch = _torch_batch(x, z, eps)
    flags = {}
    for player, step in (("gen", gen_step), ("discrim", discrim_step)):
        before = (tt.rgb_beta_tail.launches, tt.rgb_beta_tail.launches_bwd, len(plain_launches))
        new, _ = step(state0, *batch, LR)
        assert tt.rgb_beta_tail.launches - before[0] == 2, player
        assert tt.rgb_beta_tail.launches_bwd - before[1] == len(plain_launches) - before[2], player
        flags[player] = plain_launches[before[2]:]
        got = tckpt.train_state_to_reference(new)
        want_state = after[player][0]
        for part in (player, "latent"):
            assert got["parts"][part][next(iter(got["parts"][part]))].dtype == np.float64
            tp.assert_grads_close(got["opt"][part]["mu"], want_state["opt"][part].mu)
    assert flags == {"gen": [(True, True)] * 2, "discrim": [(True, False)]}


def test_chip_smoke_reads_the_backwards_launches_from_their_device_kernels_names():
    """chip_smoke.py holds the wrappers' counts to the device kernels the
    profiler records: a tail backward call is witnessed by its first pass in
    either form (bf16 over a float32 trunk too), a head backward call by the
    trunk's transposed conv; the tail backward's other passes and the passes
    the head's backward runs inside its own call count for nothing."""
    from chip_smoke import witnessed

    args = "(npe::TailBwdArgs<float, float>)"
    kernels = {f"void npe::tail_bwd_green_kernel<float, float, false>{args}": 5,
               f"void npe::tail_bwd_blue_kernel<float, float, false>{args}": 5,
               f"void npe::tail_bwd_taps_kernel<float, float>{args}": 2,
               "void npe::tail_bwd_taps_sum_kernel<float>(float const*, int, float*, float*)": 2,
               "void npe::tail_bwd_green_kernel<__nv_bfloat16, __nv_bfloat16, false>(npe::TailBwdArgs)": 3,
               "void npe::tail_bwd_green_kernel<float, __nv_bfloat16, false>(npe::TailBwdArgs)": 1,
               f"void npe::tail_bwd_green_kernel<float, float, true>{args}": 7,
               f"void npe::tail_bwd_red_kernel<float, float, true>{args}": 7,
               "void (anonymous namespace)::head_trunk_bwd_kernel<float>(float const*, float const*, float*, int)": 7,
               "void (anonymous namespace)::head_trunk_bwd_kernel<__nv_bfloat16>(float const*, int)": 2}
    assert witnessed(kernels) == {"rgb_beta_tail_bwd": 5, "rgb_beta_tail_bwd_bf16": 4, "rgb_beta_head_bwd": 7,
                                  "rgb_beta_head_bwd_bf16": 2}


def test_chip_smoke_bounds_of_the_backwards():
    """The tail's backward at a training step's batch of 16: 21.2 M
    multiply-adds an image (the forward again 7.08 M, B^T and G^T 7.08 M,
    dtb and dtg 7.08 M), about 0.010 ms at 67 TFLOP/s of float32, bound by
    the operations; without the taps' gradients two thirds of that. The
    head's x-gradient adds 6 * C multiply-adds a pixel over 33 offsets."""
    from chip_smoke import rgb_beta_head_bwd_bound_ms, rgb_beta_tail_bwd_bound_ms

    ms, by = rgb_beta_tail_bwd_bound_ms(16)
    assert by == "operations" and 0.0100 < ms < 0.0108, ms
    assert abs(rgb_beta_tail_bwd_bound_ms(16, need_taps=False)[0] / ms - 0.67) < 0.02
    head_ms, head_by = rgb_beta_head_bwd_bound_ms(1, 64)
    assert head_by == "operations" and abs(head_ms - (2 * 256 * 27648 * 2 + 4096 * 2 * 33 * 64 * 6) / 67e9) < 1e-4
