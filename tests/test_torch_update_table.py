"""The one-launch noisy update's leaf table (``kernels/noisy_update.py``):
what the kernel's blocks cover, the device-table cache, and the CPU path of
``tree_noisy_update`` against the reference's kernel path for every noise
source.

The walk over the table is checked through ``leaf_table_elements``, the
plain model of the kernel's work items; the CUDA kernel itself runs only on
the card (``chip_smoke.py`` holds it bitwise against the per-leaf plain
update).  Tolerances as in ``test_torch_kernels.py``: 1e-6 absolute, the
reference contracting into FMAs on XLA:CPU.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.utils.params import FlatGradView as RefView
from repro_torch.kernels import noisy_update as nu
from repro_torch.utils.params import FlatGradView, params_from_numpy

SEED = (123456789, 987654321)

# leaf sizes that start off 4, end off 4, span several work items, are
# smaller than a vector, and empty
SIZES = {"a": (5, 7), "b": (3,), "c": (nu.CHUNK + 5,), "d": (0,),
         "e": (2, nu.CHUNK + 1), "f": (4 * nu.CHUNK,), "g": (1,)}


def _view():
    return FlatGradView.for_params({k: torch.zeros(s) for k, s in
                                    SIZES.items()})


@pytest.mark.parametrize("phase", [0, 4, 8, 12])
@pytest.mark.parametrize("vec_ok", [True, False])
def test_leaf_table_covers_every_element_once(phase, vec_ok):
    view = _view()
    # param i in phase with its flat offset (an element at flat offset o
    # sits at 4 o bytes into the aligned flat buffers), shifted by `phase`
    ptrs = tuple(256 * (i + 1) + 4 * (o % 4) + phase
                 for i, o in enumerate(view.offsets))
    table, items = nu.build_leaf_table(view, ptrs)
    assert table.shape == (sum(n > 0 for n in view.sizes),
                           len(nu.TABLE_COLUMNS))
    els = list(nu.leaf_table_elements(table, items, vec_ok))
    seen = collections.Counter((leaf, j) for _, leaf, j, _, _ in els)
    want = {(i, j) for i, n in enumerate(view.sizes) for j in range(n)}
    assert set(seen) == want and set(seen.values()) == {1}
    assert {e[0] for e in els} == set(range(items))   # no idle work item
    rows = {int(r[3]): r for r in table}
    for item, leaf, j, flat, vec in els:
        ptr, off, n, _, head, _ = (int(v) for v in rows[leaf])
        assert (ptr, off, n) == (ptrs[leaf], view.offsets[leaf],
                                 view.sizes[leaf])
        assert flat == off + j
        if vec:
            # a vector element: its vector's first element is 16-byte
            # aligned in the param and in the (aligned) flat buffers
            first = j - (j - head) % nu.VEC
            assert vec_ok and head >= 0
            assert (ptr + 4 * first) % 16 == 0 and (off + first) % 4 == 0
    for r in table:
        ptr, off, n, leaf, head, _ = (int(v) for v in r)
        h = min((-off) % 4, n)
        # the alignment flag: the param's phase matches the flat buffers'
        assert head == (h if (ptr + 4 * h) % 16 == 0 else -1)
    # whole vectors wherever the phases allow them: all but a head and a
    # tail of fewer than 4 elements per leaf
    n_vec = sum(e[4] for e in els)
    if vec_ok and phase == 0:
        assert n_vec >= view.n_params - 6 * len(view.sizes)
    else:
        assert n_vec == 0


def test_leaf_table_phase_follows_each_param():
    view = _view()
    ptrs = tuple(256 * (i + 1) + 4 * (i % 4) for i in range(len(view.names)))
    table, _ = nu.build_leaf_table(view, ptrs)
    for ptr, off, n, leaf, head, _ in table.tolist():
        assert (head >= 0) == ((ptr + 4 * min((-off) % 4, n)) % 16 == 0)


def test_device_leaf_table_is_cached_and_rebuilt_for_a_new_param():
    params = {k: torch.zeros(s) for k, s in SIZES.items()}
    view = FlatGradView.for_params(params)
    ptrs = lambda: tuple(params[n].data_ptr() for n in view.names)
    dev = torch.device("cpu")
    first = nu.device_leaf_table(view, ptrs(), dev)
    assert nu.device_leaf_table(view, ptrs(), dev) is first
    old = params["c"].data_ptr()
    params["c"] = torch.zeros(SIZES["c"])          # a replaced tensor
    assert params["c"].data_ptr() != old
    again = nu.device_leaf_table(view, ptrs(), dev)
    assert again is not first
    table, n_rows, items = again
    row = table[table[:, 3] == view.names.index("c")][0]
    assert int(row[0]) == params["c"].data_ptr()
    assert (n_rows, items) == (first[1], first[2])
    want, _ = nu.build_leaf_table(view, ptrs())
    np.testing.assert_array_equal(table.numpy(), want)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("noise", ["operand", "none", "threefry"])
def test_cpu_tree_noisy_update_matches_reference(noise, momentum):
    """The CPU path (the plain per-leaf loop) against the reference's
    kernel path (interpret mode) for every noise source."""
    rng = np.random.default_rng(9)
    tree = {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32),
            "z": {"k": rng.standard_normal((3, 3, 2)).astype(np.float32)}}
    jtree = jax.tree.map(jnp.asarray, tree)
    rview = RefView.for_tree(jtree)
    acc = np.zeros(rview.total, np.float32)
    acc[:rview.n_params] = rng.standard_normal(rview.n_params)
    mom = np.zeros(rview.total, np.float32)
    mom[:rview.n_params] = rng.standard_normal(rview.n_params)
    key = jnp.asarray(SEED, jnp.uint32)
    z = np.asarray(rview.noise(jax.random.PRNGKey(4)))
    kw = dict(momentum_buf=jnp.asarray(mom), momentum=momentum) if momentum \
        else {}
    if noise == "operand":
        # the reference draws view.noise(key) from a jax key: hand the same
        # draw to the port as its operand
        rkey = jax.random.PRNGKey(4)
        out = ref_ops.tree_noisy_update(jtree, jnp.asarray(acc), rkey, 1.5,
                                        8.0, 0.1, use_kernel=True,
                                        interpret=True, in_kernel_rng=False,
                                        **kw)
    else:
        out = ref_ops.tree_noisy_update(
            jtree, jnp.asarray(acc), key if noise == "threefry" else None,
            1.5, 8.0, 0.1, use_kernel=True, interpret=True,
            in_kernel_rng=True, **kw)
    rp, rm = out
    params = params_from_numpy(tree, "cpu")
    view = FlatGradView.for_params(params)
    tm = torch.from_numpy(mom.copy()) if momentum else None
    nu.tree_noisy_update(
        params, torch.from_numpy(acc), SEED if noise == "threefry" else None,
        1.5, 8.0, 0.1, view=view, momentum_buf=tm, momentum=momentum,
        noise=torch.from_numpy(z.copy()) if noise == "operand" else None)
    for leaf, name in zip(jax.tree.leaves(rp), view.names):
        np.testing.assert_allclose(params[name].numpy(), np.asarray(leaf),
                                   rtol=0, atol=1e-6)
    if momentum:
        np.testing.assert_allclose(tm.numpy(), np.asarray(rm), rtol=0,
                                   atol=1e-6)


def test_cpu_tree_noisy_update_counts_no_launch():
    params = {"w": torch.ones(10)}
    view = FlatGradView.for_params(params)
    before = nu.noisy_sgd_update.launches
    nu.tree_noisy_update(params, view.zeros("cpu"), SEED, 1.0, 1.0, 0.1,
                         view=view)
    assert nu.noisy_sgd_update.launches == before
