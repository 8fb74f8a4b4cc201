"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
``moe_block`` on the same numpy inputs from a seed, in float32: reduced
olmoe-1b-7b (8 experts, top 4) and reduced arctic-480b (8 experts, top 2,
with the dense residual branch), both dispatches, a capacity factor that
drops nothing and one that drops.

- ``x + y`` and the three aux values within 1e-5 (the expert products
  sum in another order);
- the selected experts exactly, and the dispatch buffers (which token row
  lands in which expert slot, so which assignments are dropped) exactly;
- a ragged last group (tokens not a multiple of ``moe_group_size``): the
  reference asserts there; the port routes the last group at its own size,
  held here against the reference run group by group."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.models import moe, params as tparams_mod  # noqa: E402
from repro_torch.models import get_family, init_params  # noqa: E402
from repro_torch.models.params import (params_from_reference,  # noqa: E402
                                       tree_map_specs)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_params(specs, seed):
    """Reference-scaled weights: ones for the norm, the others normal,
    clipped at 2 sigma, scaled by fan-in."""
    rng = np.random.RandomState(seed)

    def leaf(spec):
        if spec.init == "ones":
            return np.ones(spec.shape, np.float32)
        std = float(np.prod(spec.shape[:-1])) ** -0.5
        return (np.clip(rng.randn(*spec.shape), -2, 2) * std).astype(
            np.float32)

    return tree_map_specs(leaf, specs)


def _setup(arch, **kw):
    jcfg = jax_reduced(arch).replace(dtype="float32", **kw)
    tcfg = get_reduced_config(arch).replace(dtype="float32", **kw)
    specs = moe.moe_param_specs(tcfg)
    np_p = _np_params(specs, seed=0)
    tp = params_from_reference(tcfg, specs, np_p, device="cpu")
    jp = {k: jnp.asarray(v) for k, v in np_p.items()}
    return jcfg, tcfg, jp, tp


def _x(tcfg, b, s, seed=1):
    return np.random.RandomState(seed).randn(b, s, tcfg.d_model).astype(
        np.float32)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want), **TOL, err_msg=what)


# capacity factor: 8 experts / top 4 or top 2 -> this many times the even
# share never drops; 1.0 drops the overflow of popular experts
NO_DROP = 4.0


@pytest.mark.parametrize("impl", ["einsum", "sort"])
@pytest.mark.parametrize("cf", [NO_DROP, 1.0], ids=["no_drop", "dropping"])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b"])
def test_moe_block_matches_reference(arch, cf, impl):
    jcfg, tcfg, jp, tp = _setup(arch, capacity_factor=cf, moe_impl=impl)
    x = _x(tcfg, 2, 64)                             # two groups of 64
    jy, jaux = jmoe.moe_block(jcfg, jp, jnp.asarray(x))
    ty, taux = moe.moe_block(tcfg, tp, torch.from_numpy(x))
    _close(ty, jy, "x + y")
    for name, want in jaux.items():
        _close(taux[name], want, name)
    dropped = float(taux["moe_drop_frac"])
    assert (dropped == 0.0) if cf == NO_DROP else (dropped > 0.0)

    # routing and dispatch, group by group: the same experts, the same rows
    # in the same slots (a dropped assignment lands nowhere)
    xn = moe.rmsnorm(torch.from_numpy(x), tp["norm"]).numpy()
    xg = xn.reshape(2, 64, tcfg.d_model)
    cap = moe.expert_capacity(tcfg, 64)
    assert cap == jmoe.expert_capacity(jcfg, 64)
    _, _, jgate, jsel = jmoe._route(jcfg, jp, jnp.asarray(xg))
    _, _, tgate, tsel = moe._route(tcfg, tp, torch.from_numpy(xg))
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    _close(tgate, jgate, "gates")
    jdisp = (jmoe._sort_dispatch if impl == "sort" else jmoe._einsum_dispatch)
    tdisp = (moe._sort_dispatch if impl == "sort" else moe._einsum_dispatch)
    jein, _, _ = jdisp(jcfg, jnp.asarray(xg), jgate, jsel, cap)
    tein, _, kept = tdisp(tcfg, torch.from_numpy(xg), tgate, tsel, cap)
    np.testing.assert_array_equal(tein.numpy(), np.asarray(jein))
    assert int(kept) == int(np.any(np.asarray(jein) != 0, -1).sum())


def test_dispatches_agree_and_dense_branch_adds():
    """The two dispatches give one result; Arctic's dense branch is the
    difference between the block with and without ``moe_dense_ff``."""
    _, tcfg, _, tp = _setup("arctic-480b", capacity_factor=1.0)
    x = torch.from_numpy(_x(tcfg, 2, 64, seed=2))
    ye, ae = moe.moe_block(tcfg, tp, x)
    ys, as_ = moe.moe_block(tcfg.replace(moe_impl="sort"), tp, x)
    _close(ys, ye.numpy(), "sort vs einsum")
    assert float(ae["moe_drop_frac"]) == float(as_["moe_drop_frac"])
    y0, _ = moe.moe_block(tcfg.replace(moe_dense_ff=0), tp, x)
    xn = moe.rmsnorm(x, tp["norm"])
    dense = (torch.nn.functional.silu(xn @ tp["dense_gate"])
             * (xn @ tp["dense_up"])) @ tp["dense_down"]
    _close(ye - y0, dense.numpy(), "dense residual branch")


@pytest.mark.parametrize("impl", ["einsum", "sort"])
def test_ragged_last_group_against_per_group_reference(impl):
    """160 tokens in groups of 64: two whole groups and a last one of 32,
    with its own capacity (the reference asserts a whole number of groups).
    ``x + y`` equals the reference run on each group alone; the drop share
    and z-loss are the token-weighted means of the groups', the load
    balance loss is computed from the reference's routing of all three."""
    jcfg, tcfg, jp, tp = _setup("olmoe-1b-7b", capacity_factor=1.0,
                                moe_impl=impl)
    assert moe._groups(tcfg, 160) == [(2, 64), (1, 32)]
    assert moe.expert_capacity(tcfg, 32) < moe.expert_capacity(tcfg, 64)
    x = _x(tcfg, 2, 80, seed=3)
    with pytest.raises(AssertionError, match="not divisible"):
        jmoe.moe_block(jcfg, jp, jnp.asarray(x))
    ty, taux = moe.moe_block(tcfg, tp, torch.from_numpy(x))
    flat = x.reshape(160, tcfg.d_model)
    parts = [flat[:64], flat[64:128], flat[128:]]
    outs = [jmoe.moe_block(jcfg, jp, jnp.asarray(p[None])) for p in parts]
    want = np.concatenate([np.asarray(y[0]) for y, _ in outs])
    _close(ty.reshape(160, -1), want, "x + y")
    sizes = np.array([len(p) for p in parts], np.float64)
    for name in ("moe_drop_frac", "moe_z_loss"):
        vals = np.array([float(a[name]) for _, a in outs])
        _close(taux[name], (vals * sizes).sum() / sizes.sum(), name)
    assert float(taux["moe_drop_frac"]) > 0.0
    xn = moe.rmsnorm(torch.from_numpy(flat), tp["norm"]).numpy()
    probs, top1 = [], []
    for i, j in ((0, 64), (64, 128), (128, 160)):
        _, p_, _, sel = jmoe._route(jcfg, jp, jnp.asarray(xn[None, i:j]))
        probs.append(np.asarray(p_)[0])
        top1.append(np.asarray(sel)[0, :, 0])
    e = tcfg.num_experts
    f_e = np.eye(e)[np.concatenate(top1)].mean(0)
    lb = e * np.sum(f_e * np.concatenate(probs).mean(0))
    _close(taux["moe_lb_loss"], lb, "moe_lb_loss")


def test_expert_capacity_matches_reference():
    for arch, gs in (("olmoe-1b-7b", 8), ("olmoe-1b-7b", 512),
                     ("arctic-480b", 8), ("arctic-480b", 512)):
        assert moe.expert_capacity(get_config(arch), gs) \
            == jmoe.expert_capacity(jax_config(arch), gs)
    assert moe.expert_capacity(get_config("olmoe-1b-7b"), 8) == 2
    assert moe.expert_capacity(get_config("olmoe-1b-7b"), 512) == 80
    assert moe.expert_capacity(get_config("arctic-480b"), 8) == 1


def test_init_draws_a_large_layer_part_a_slice_at_a_time(monkeypatch):
    """A layer part over ``SCRATCH_ELEMS`` elements is drawn one expert at
    a time: the same shapes, dtypes and truncation, and every expert
    drawn (no all-zero slice)."""
    tcfg = get_reduced_config("arctic-480b")
    layout = get_family(tcfg).layout(tcfg)
    monkeypatch.setattr(tparams_mod, "SCRATCH_ELEMS", 1000)
    p = init_params(tcfg, layout, seed=0, device="cpu")
    we = p["layers"]["ffn"]["we_gate"]
    assert we.shape == (2, 8, 64, 96) and we.dtype == torch.bfloat16
    assert p["layers"]["ffn"]["router"].dtype == torch.float32
    std = (2 * 8 * 64) ** -0.5
    assert float(we.float().abs().max()) <= 2.0 * std * 1.01
    assert bool((we.float().abs().amax(dim=(2, 3)) > 0).all())
