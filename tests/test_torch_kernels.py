"""The port's kernels (plain versions, as a CPU tensor takes them) against
the reference's Pallas kernels in interpret mode, on inputs made from a seed
with numpy.

Tolerances:
* ``clip_accum_inplace``: bitwise — both sides fold strictly left over the
  examples with one rounding per op.
* ``noisy_sgd_update`` with a noise operand or none: 1e-6 absolute on
  N(0,1) inputs (2 ULPs of the largest operands).  The reference, run on
  XLA:CPU, contracts ``a + s*z`` and ``p - lr*m`` into fused multiply-adds;
  the port rounds every op (as its CUDA kernel does with
  ``__fmul_rn``/``__fadd_rn``), and equals the uncontracted f32 sequence
  bitwise.
* Threefry bits: bitwise.  Normals: within 4 ULPs of max(|z|, 1) (``log``
  and ``cos`` differ between XLA:CPU and PyTorch by a few ULPs).
* ``ghost_norm_dense`` plain version against ``ghost_norm_dense_ref``: 1e-5
  relative (the same f32 products summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.clip_accum import clip_accum_inplace as ref_clip_inplace
from repro.kernels.noisy_update import bits_to_normal as ref_bits_to_normal
from repro.kernels.noisy_update import noisy_sgd_update as ref_noisy
from repro.kernels.noisy_update import threefry2x32 as ref_threefry
from repro.kernels.ref import ghost_norm_dense_ref
from repro.utils.params import FlatGradView as RefView
from repro_torch.kernels import clip_accum as ca
from repro_torch.kernels import ghost_norm as gn
from repro_torch.kernels import noisy_update as nu
from repro_torch.utils.params import FlatGradView, params_from_numpy

SEED = (123456789, 987654321)


def _vecs(n, k, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(k)]


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("noise", ["operand", "none"])
def test_noisy_sgd_update_matches_reference(momentum, noise):
    p, a, z, m = _vecs(10000, 4, seed=7)
    kw = dict(momentum_buf=jnp.asarray(m), momentum=momentum) if momentum \
        else {}
    ref = ref_noisy(jnp.asarray(p), jnp.asarray(a),
                    jnp.asarray(z) if noise == "operand" else None,
                    1.5, 64.0, 0.01, **kw)
    rp, rm = (ref if momentum else (ref, None))
    tp, tm = nu.noisy_sgd_update(
        torch.from_numpy(p.copy()), torch.from_numpy(a),
        torch.from_numpy(z) if noise == "operand" else None, 1.5, 64.0, 0.01,
        momentum_buf=torch.from_numpy(m.copy()) if momentum else None,
        momentum=momentum)
    np.testing.assert_allclose(tp.numpy(), np.asarray(rp), rtol=0,
                               atol=1e-6)
    # the port is the uncontracted f32 sequence, bit for bit
    f = np.float32
    g = (a + f(1.5) * z if noise == "operand" else a) * f(1 / 64.0)
    if momentum:
        np.testing.assert_allclose(tm.numpy(), np.asarray(rm), rtol=0,
                                   atol=1e-6)
        mm = f(momentum) * m + g
        np.testing.assert_array_equal(tm.numpy(), mm)
        np.testing.assert_array_equal(tp.numpy(), p - f(0.01) * mm)
    else:
        np.testing.assert_array_equal(tp.numpy(), p - f(0.01) * g)


def test_threefry_bits_match_reference():
    n = 5000
    c = jnp.arange(n, dtype=jnp.uint32)
    r0, r1 = ref_threefry(SEED[0], SEED[1], c, jnp.zeros(n, jnp.uint32))
    t0, t1 = nu.threefry_bits(SEED, n, "cpu")
    np.testing.assert_array_equal(np.asarray(r0).astype(np.int64), t0.numpy())
    np.testing.assert_array_equal(np.asarray(r1).astype(np.int64), t1.numpy())
    # scalar (host) use, as step_seeds does
    assert nu.threefry2x32(SEED[0], SEED[1], 17, 0) == (
        int(r0[17]), int(r1[17]))


def test_bits_to_normal_matches_reference():
    rng = np.random.default_rng(3)
    b1 = rng.integers(0, 2 ** 32, 20000, dtype=np.uint64)
    b2 = rng.integers(0, 2 ** 32, 20000, dtype=np.uint64)
    rz = np.asarray(ref_bits_to_normal(jnp.asarray(b1, jnp.uint32),
                                       jnp.asarray(b2, jnp.uint32)))
    tz = nu.bits_to_normal(torch.from_numpy(b1.astype(np.int64)),
                           torch.from_numpy(b2.astype(np.int64))).numpy()
    bound = 4 * np.spacing(np.maximum(np.abs(rz), np.float32(1)))
    assert np.all(np.abs(rz - tz) <= bound)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_in_kernel_threefry_update_matches_reference(momentum):
    """The reference's interpret-mode Threefry kernel body vs the port's
    Threefry noise: same counters, same key; normals within a few ULPs."""
    p, a, m = _vecs(6000, 3, seed=11)
    kw = dict(momentum_buf=jnp.asarray(m), momentum=momentum) if momentum \
        else {}
    ref = ref_noisy(jnp.asarray(p), jnp.asarray(a), None, 2.0, 4.0, 0.5,
                    seed=jnp.asarray(SEED, jnp.uint32), tile=4096, **kw)
    rp = ref[0] if momentum else ref
    tp, _ = nu.noisy_sgd_update(
        torch.from_numpy(p.copy()), torch.from_numpy(a), None, 2.0, 4.0, 0.5,
        momentum_buf=torch.from_numpy(m.copy()) if momentum else None,
        momentum=momentum, seed=SEED)
    np.testing.assert_allclose(tp.numpy(), np.asarray(rp), rtol=0,
                               atol=2e-6)


def test_tree_noisy_update_folds_leaf_index_into_seed():
    """Leaf order, offsets and the per-leaf seed (+i on both words) match
    the reference's kernel path with in-kernel noise."""
    rng = np.random.default_rng(5)
    tree = {"b": rng.standard_normal(300).astype(np.float32),
            "a": {"w": rng.standard_normal((5, 7)).astype(np.float32)},
            "c": {"x": rng.standard_normal((2, 3, 4)).astype(np.float32)}}
    jtree = jax.tree.map(jnp.asarray, tree)
    rview = RefView.for_tree(jtree)
    acc = np.zeros(rview.total, np.float32)
    acc[:rview.n_params] = rng.standard_normal(rview.n_params)
    mom = np.zeros(rview.total, np.float32)
    key = jnp.asarray(SEED, jnp.uint32)
    rp, rm = ref_ops.tree_noisy_update(
        jtree, jnp.asarray(acc), key, 1.5, 8.0, 0.1, momentum_buf=jnp.asarray(
            mom), momentum=0.9, use_kernel=True, interpret=True,
        in_kernel_rng=True)
    params = params_from_numpy(tree, "cpu")
    view = FlatGradView.for_params(params)
    tm = torch.from_numpy(mom.copy())
    nu.tree_noisy_update(params, torch.from_numpy(acc), SEED, 1.5, 8.0, 0.1,
                         view=view, momentum_buf=tm, momentum=0.9)
    flat_ref = jax.tree.leaves(rp)
    for leaf, name in zip(flat_ref, view.names):
        np.testing.assert_allclose(params[name].numpy(), np.asarray(leaf),
                                   rtol=0, atol=1e-6)
    np.testing.assert_allclose(tm.numpy(), np.asarray(rm), rtol=0, atol=1e-6)
    assert not tm[view.n_params:].any()        # the tail stays zero


def test_step_seeds_are_a_function_of_key_and_step():
    assert nu.step_seeds((0, 1), 3) == nu.step_seeds((0, 1), 3)
    assert nu.step_seeds((0, 1), 3) != nu.step_seeds((0, 1), 4)
    assert nu.step_seeds((0, 1), 3) != nu.step_seeds((0, 2), 3)
    assert nu.step_seeds((0, 1), 3) == nu.threefry2x32(0, 1, 3, 0)


@pytest.mark.parametrize("m", [1, 2, 3, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_accum_inplace_bitwise_vs_reference(m, dtype):
    rng = np.random.default_rng(m)
    d = 2048
    g = rng.standard_normal((m, d)).astype(np.float32)
    acc = rng.standard_normal(d).astype(np.float32)
    norms = (np.abs(rng.standard_normal(m)) * 3).astype(np.float32)
    norms[0] = 0.0                                 # the 1e-12 floor
    mask = (rng.random(m) > 0.3).astype(np.float32)
    gj = jnp.asarray(g, getattr(jnp, dtype))
    gt = torch.from_numpy(g).to(getattr(torch, dtype))
    ref = np.asarray(ref_clip_inplace(jnp.asarray(acc), gj,
                                      jnp.asarray(norms), jnp.asarray(mask),
                                      1.3))
    out = ca.clip_accum_inplace(torch.from_numpy(acc.copy()), gt,
                                torch.from_numpy(norms),
                                torch.from_numpy(mask), 1.3)
    np.testing.assert_array_equal(out.numpy().view(np.int32),
                                  ref.view(np.int32))


def test_clip_accum_inplace_is_tile_invariant():
    """One fold from the carry: any split of the rows gives the same bits."""
    rng = np.random.default_rng(9)
    g = torch.from_numpy(rng.standard_normal((6, 512)).astype(np.float32))
    norms = torch.from_numpy(rng.random(6).astype(np.float32) * 4)
    mask = torch.ones(6)
    whole = ca.clip_accum_inplace(torch.zeros(512), g, norms, mask, 1.0)
    acc = torch.zeros(512)
    for s in (slice(0, 1), slice(1, 4), slice(4, 6)):
        ca.clip_accum_inplace(acc, g[s].contiguous(), norms[s], mask[s], 1.0)
    assert torch.equal(whole, acc)


def _noisy_args(**over):
    args = dict(params=torch.zeros(8), acc=torch.zeros(8), noise=None)
    args.update(over)
    return args


@pytest.mark.parametrize("over,exc", [
    (dict(acc=torch.zeros(8, device="meta")), ValueError),
    (dict(acc=torch.zeros(8, dtype=torch.float64)), TypeError),
    (dict(acc=torch.zeros(9)), ValueError),
    (dict(acc=torch.zeros(16)[::2]), ValueError),
    (dict(params=torch.zeros(2, 4), acc=torch.zeros(2, 4)), ValueError),
    (dict(noise=torch.zeros(7)), ValueError),
])
def test_noisy_sgd_update_rejects_bad_operands(over, exc):
    a = _noisy_args(**over)
    with pytest.raises(exc):
        nu.noisy_sgd_update(a["params"], a["acc"], a["noise"], 1.0, 1.0,
                            0.1)


def test_noisy_sgd_update_rejects_noise_and_seed():
    with pytest.raises(ValueError):
        nu.noisy_sgd_update(torch.zeros(4), torch.zeros(4), torch.zeros(4),
                            1.0, 1.0, 0.1, seed=(1, 2))


@pytest.mark.parametrize("over,exc", [
    (dict(acc=torch.zeros(8, device="meta")), ValueError),
    (dict(grads=torch.zeros(2, 8, dtype=torch.float16)), TypeError),
    (dict(norms=torch.zeros(2, dtype=torch.float64)), TypeError),
    (dict(acc=torch.zeros(9)), ValueError),
    (dict(mask=torch.zeros(3)), ValueError),
    (dict(grads=torch.zeros(8, 2).T), ValueError),
    (dict(grads=torch.zeros(16)), ValueError),
])
def test_clip_accum_inplace_rejects_bad_operands(over, exc):
    a = dict(acc=torch.zeros(8), grads=torch.zeros(2, 8),
             norms=torch.ones(2), mask=torch.ones(2))
    a.update(over)
    with pytest.raises(exc):
        ca.clip_accum_inplace(a["acc"], a["grads"], a["norms"], a["mask"],
                              1.0)


# --------------------------------------------------------------------------
# ghost_norm_dense: the wrapper's Python side and the plain version at the
# head's T = 1, ViT's T = 197 and widths off every tile
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape,tiles", [
    ((32, 768, 100), {"bfloat16": 6, "float32": 24}),    # ViT-Base's head
    ((3, 100, 72), {"bfloat16": 1, "float32": 4}),       # ragged
    ((4, 896, 896), {"bfloat16": 49, "float32": 196}),   # qwen2-0.5b
    ((2, 128, 129), {"bfloat16": 2, "float32": 6}),
])
def test_ghost_norm_scratch_sizes(shape, tiles):
    B, din, dout = shape
    for name, n in tiles.items():
        dt = getattr(torch, name)
        assert gn.n_tiles(din, dout, dt) == n
        assert gn.scratch_sizes(B, din, dout, dt) == (B * n, B)


def test_ghost_norm_scratch_grows_and_keeps_tickets_zero():
    """The scratch is kept per (device, stream): calls that may overlap
    on two streams never share partials or tickets."""
    dev = torch.device("cpu")
    for stream in (0, 1):
        gn._SCRATCH.pop((dev, stream), None)
    p, t = gn._scratch(dev, 0, 40, 5)
    assert p.dtype == torch.float32 and p.numel() == 40
    assert t.dtype == torch.int32 and t.numel() == 5 and not t.any()
    assert gn._scratch(dev, 0, 12, 3)[0] is p         # big enough: kept
    other = gn._scratch(dev, 1, 12, 3)                # another stream: its own
    assert other[0] is not p and other[1] is not t
    p2, t2 = gn._scratch(dev, 0, 30, 9)               # more tickets: grown
    assert p2.numel() == 40 and t2.numel() == 9 and not t2.any()
    assert gn._scratch(dev, 1, 12, 3)[0] is other[0]
    for stream in (0, 1):
        gn._SCRATCH.pop((dev, stream), None)


@pytest.mark.parametrize("shape", [(2, 1, 100, 72), (2, 197, 100, 72),
                                   (1, 197, 130, 70), (3, 1, 768, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ghost_norm_dense_plain_matches_ref_at_vit_lengths(shape, dtype):
    """T = 1 (the head, on every ghost and BK norm pass), T = 197 (ViT's
    blocks) and din, dout off the kernel's tiles: the wrapper's CPU path
    against the reference's ``ghost_norm_dense_ref``, 1e-5 relative."""
    B, T, di, do = shape
    rng = np.random.default_rng(T + di)
    x = rng.standard_normal((B, T, di)).astype(np.float32)
    dy = rng.standard_normal((B, T, do)).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    dt = torch.from_numpy(dy).to(getattr(torch, dtype))
    got = gn.ghost_norm_dense(xt, dt).numpy()
    want = np.asarray(ghost_norm_dense_ref(
        jnp.asarray(xt.float().numpy()), jnp.asarray(dt.float().numpy())))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert gn.ghost_norm_dense.launches == 0       # the CPU launches nothing
