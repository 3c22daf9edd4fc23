"""The port's hybrid family at the module level against the JAX package,
at the reference's hybrid smoke config (``smoke_config("jamba-v0.1-52b")``:
one period of 4 layers, attention at position 1 on an MoE slot, d 64, 4/2
heads of 16, 4 experts top-2 every other layer, Mamba-2 mixers of 8 heads
of 16, chunk 16, vocab 512) and at two periods (``num_layers=8``, which
the reference accepts): parameter names, shapes and specs against the
reference's abstract init at the smoke and the full config; the forward
with its caches and the prefill's regrouped cache on the reference's own
parameters; the place of each period position's mixer, FFN and norms in
the ``periods.*`` stacks; the aux term over all layers; the decode against
one forward.

One period alone would not show a wrong ``pi·(period − 1) + mi`` row or a
stack sliced per period, so every comparison also runs two.  The
reference's parameters are drawn once at two periods (``model.init``
inside ``jax.threefry_partitionable(False)``); one period's are their
first period's rows, a valid parameter set of the one-period model.  The
reference runs op by op with ``attn_impl="xla"`` (the chunked attention);
the port runs its main path, flash attention, whose plain blockwise
version a CPU tensor takes.  Both route every MoE call alike: the
reference's routes are recorded (``jax.debug.callback``, which fires per
period inside its scan) and the port takes them, checked to differ from
its own only where the reference's k-th against (k+1)-th probability
margin is at most ``TIE`` = 1e-5.

Tolerances, f32: hidden states, logits and caches within ``F32_TOL`` =
1e-4 of the compared tensor's largest |value| (readings about 2e-5: the
port's SSD sums its chunk products in another order, the attention's
blockwise online softmax against the chunked one); the aux loss 1e-5
relative; the prefill's bf16 conv windows and K/V within ``BF16_TOL`` =
1e-2 (one bf16 rounding of values that differ in their last f32 bits).
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as JRunConfig
from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import smoke_config as j_smoke_config
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro_torch import convert
from repro_torch.configs.base import RunConfig
from repro_torch.configs.registry import get_config, hybrid_layout, param_shapes, smoke_config
from repro_torch.kernels import backend
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

ARCH = "jamba-v0.1-52b"
SIZES = {"data": 1, "model": 1}
B, S = 2, 32
PERIODS = (1, 2)
TIE = 1e-5
F32_TOL, BF16_TOL = 1e-4, 1e-2


def _cfgs(periods: int):
    """(reference config, port config) of the smoke model at ``periods``
    periods of 4 layers."""
    return (dataclasses.replace(j_smoke_config(ARCH), num_layers=4 * periods),
            dataclasses.replace(smoke_config(ARCH), num_layers=4 * periods))


def _jrun():
    return JRunConfig(attn_impl="xla", attn_chunk_q=16, attn_chunk_k=16, remat=False)


def _run():
    return RunConfig(attn_chunk_q=16, attn_chunk_k=16, remat=False, compute_dtype="float32")


def _close(got, want, tol, what=""):
    got = np.asarray(got.detach().float().numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
    assert err <= tol, f"{what}: max |Δ| / max |ref| = {err:.3g} > {tol}"
    return err


@functools.lru_cache(maxsize=None)
def _jparams_two():
    jcfg, _ = _cfgs(2)
    ctx = jmodel.make_ctx(jcfg, _jrun(), SIZES)
    with jax.threefry_partitionable(False):
        params, specs = jmodel.init(jax.random.PRNGKey(0), jcfg, ctx, SIZES, _jrun())
    return {k: np.array(v) for k, v in params.items()}, specs


def _jparams(periods: int):
    """The reference's parameters of the first ``periods`` periods."""
    params, specs = _jparams_two()
    if periods == 2:
        return params, specs
    shapes, _ = param_shapes(_cfgs(periods)[1])
    return {k: v[:shapes[k][0]] if k.startswith("periods.") else v
            for k, v in params.items()}, specs


def _tokens(s: int = S, seed: int = 9):
    return np.random.default_rng(seed).integers(0, 512, (B, s)).astype(np.int32)


def _margin(probs, k):
    top = -np.sort(-probs, axis=-1)
    return top[:, k - 1] - top[:, k]


@contextlib.contextmanager
def _reference_routes(log):
    """Within the span every reference ``moe_block`` / ``moe_decode`` call
    appends (probs, expert ids) of its tokens to ``log``, at run time (a
    callback also fires per iteration of the period scan)."""
    block, decode = jmoe.moe_block, jmoe.moe_decode

    def record(p, x, cfg):
        t = x.shape[0] * x.shape[1]
        logits = jnp.einsum("td,de->te", x.reshape(t, -1).astype(jnp.float32),
                            p["router"].astype(jnp.float32))
        probs = jax.nn.softmax(logits, axis=-1)
        ids = jax.lax.top_k(probs, cfg.top_k)[1]
        jax.debug.callback(lambda pr, i: log.append((np.asarray(pr), np.asarray(i))),
                           probs, ids, ordered=True)

    def rec_block(ctx, p, x, cfg):
        record(p, x, cfg)
        return block(ctx, p, x, cfg)

    def rec_decode(ctx, p, x, cfg):
        record(p, x, cfg)
        return decode(ctx, p, x, cfg)

    jmoe.moe_block, jmoe.moe_decode = rec_block, rec_decode
    try:
        yield log
    finally:
        jmoe.moe_block, jmoe.moe_decode = block, decode
        jax.effects_barrier()


@contextlib.contextmanager
def _forced(routes, tie: float):
    """Within the span the port's ``moe.route`` takes the expert ids of
    ``routes`` (the reference's, call by call), gated by its own
    probabilities; its own ids may differ from them only at a near-tie
    (the reference's margin ≤ ``tie``).  Yields the number of calls."""
    route = tmoe.route
    calls = iter(routes)
    seen = {"calls": 0}

    def forced(router, x, cfg):
        probs, _, ids = route(router, x, cfg)
        wp, wi = next(calls)
        want = torch.from_numpy(np.array(wi)).to(ids)
        differ = (torch.sort(ids, -1).values != torch.sort(want, -1).values).any(-1).numpy()
        assert not np.any(differ & (_margin(wp, cfg.top_k) > tie)), \
            "the port routes a token away from a near-tie differently"
        seen["calls"] += 1
        gates = probs.gather(1, want)
        return probs, gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9), want

    tmoe.route = forced
    try:
        yield seen
    finally:
        tmoe.route = route


# ------------------------------------------------------------ configs, init

@pytest.mark.parametrize("which", ["smoke", "full"])
def test_param_shapes_match_reference(which):
    jcfg = j_smoke_config(ARCH) if which == "smoke" else j_get_config(ARCH)
    cfg = smoke_config(ARCH) if which == "smoke" else get_config(ARCH)
    assert convert.arch_config(jcfg) == cfg
    shapes, specs = param_shapes(cfg)
    ctx = jmodel.make_ctx(jcfg, _jrun(), SIZES, dtype=jnp.float32)
    jparams, jspecs = jmodel.init(jax.random.PRNGKey(0), jcfg, ctx, SIZES, _jrun(),
                                  abstract=True)
    assert list(shapes) == list(jparams)                      # the reference's leaf order
    assert shapes == {k: tuple(v.shape) for k, v in jparams.items()}
    assert specs == {k: tuple(v) for k, v in jspecs.items()}
    per, np_, nm, n_moe, moe_at = hybrid_layout(cfg)
    assert shapes["periods.ssm.w_x"][0] == np_ * nm and shapes["periods.attn.wq"][0] == np_
    assert shapes["periods.moe.w_up"][0] == np_ * n_moe
    assert shapes["periods.mlp.w_up"][0] == np_ * (per - n_moe)
    if which == "full":
        assert (per, np_, nm, n_moe, moe_at) == (8, 4, 7, 4, (1, 3, 5, 7))
        assert shapes["periods.moe.w_up"] == (16, 16, 4096, 14336)
        one = param_shapes(dataclasses.replace(cfg, num_layers=8))[0]
        assert sum(int(np.prod(s)) for s in one.values()) == 13_267_598_848
    else:
        assert (per, np_, nm, n_moe, moe_at) == (4, 1, 3, 2, (1, 3))


def test_init_is_seeded_and_has_the_shapes():
    _, cfg = _cfgs(2)
    params = tmodel.init(0, cfg, device="cpu")
    shapes, _ = param_shapes(cfg)
    assert list(params) == list(shapes)
    assert {k: tuple(v.shape) for k, v in params.items()} == shapes
    assert all(v.dtype == torch.float32 for v in params.values())
    for k in ("periods.norm1", "periods.norm2", "periods.ssm.norm"):
        assert torch.equal(params[k], torch.ones_like(params[k]))
    again = tmodel.init(0, cfg, device="cpu")
    assert all(torch.equal(params[k], again[k]) for k in params)


def test_layout_rejects_a_partial_period():
    _, cfg = _cfgs(1)
    with pytest.raises(ValueError, match="periods"):
        hybrid_layout(dataclasses.replace(cfg, num_layers=6))
    with pytest.raises(ValueError, match="periods"):
        hybrid_layout(dataclasses.replace(cfg, attn_offset=4))


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_period_positions_take_their_rows(which):
    """Each position of each period reads its own rows: attention row pi,
    mixer row pi·(per − 1) + mi, MoE and MLP rows by the same rule, norms
    row pi·per + i.  Every stack row carries its index (no model is
    built: the full config's rows are scalars)."""
    cfg = _cfgs(2)[1] if which == "smoke" else dataclasses.replace(get_config(ARCH),
                                                                   num_layers=16)
    per, np_, nm, n_moe, _ = hybrid_layout(cfg)
    params = {k: torch.arange(s[0], dtype=torch.float32) for k, s in param_shapes(cfg)[0].items()}
    kinds = []
    for pi in range(np_):
        layers = ttfm.period_layers(params, cfg, pi)
        mi = fi_moe = fi_mlp = 0
        for i, p in enumerate(layers):
            assert int(p["norm1"]) == int(p["norm2"]) == pi * per + i
            if "attn.wq" in p:
                assert i == cfg.attn_offset and int(p["attn.wq"]) == pi
                mixer = "a"
            else:
                assert all(int(v) == pi * nm + mi for k, v in p.items() if k.startswith("ssm."))
                mi, mixer = mi + 1, "m"
            if "moe.w_up" in p:
                assert int(p["moe.router"]) == pi * n_moe + fi_moe and "mlp.w_up" not in p
                fi_moe, ffn = fi_moe + 1, "moe"
            else:
                assert int(p["mlp.w_down"]) == pi * (per - n_moe) + fi_mlp
                fi_mlp, ffn = fi_mlp + 1, "mlp"
            kinds.append(f"{mixer}+{ffn}")
        assert (mi, fi_moe, fi_mlp) == (nm, n_moe, per - n_moe)
    if which == "full":       # jamba's period: attention at 3, on an MoE slot
        assert kinds[:8] == ["m+mlp", "m+moe", "m+mlp", "a+moe", "m+mlp", "m+moe", "m+mlp",
                             "m+moe"]
    else:
        assert kinds[:4] == ["m+mlp", "a+moe", "m+mlp", "m+moe"]
    assert kinds[per:] == kinds[:per]


# ----------------------------------------------------- forward and caches

@functools.lru_cache(maxsize=None)
def _reference_forward(periods: int):
    jcfg, _ = _cfgs(periods)
    params, specs = _jparams(periods)
    run = _jrun()
    ctx = jmodel.make_ctx(jcfg, run, SIZES, dtype=jnp.float32)
    routes = []
    with jax.threefry_partitionable(False), _reference_routes(routes):
        x = jmodel.embed_inputs(ctx, params, jcfg, {"tokens": _tokens()})
        h, aux, caches = jtfm.forward(ctx, params, specs, jcfg, run, x, jnp.arange(S),
                                      want_cache=True)
        h = np.asarray(h)
    return h, float(aux), jax.tree.map(np.asarray, caches), routes


@pytest.mark.parametrize("periods", PERIODS)
def test_forward_with_caches_matches_reference(periods):
    want_h, want_aux, want_caches, routes = _reference_forward(periods)
    jcfg, cfg = _cfgs(periods)
    assert len(routes) == periods * hybrid_layout(cfg)[3]
    run = _run()
    ctx = tmodel.make_ctx(cfg, run)
    params = convert.tree_to_torch(_jparams(periods)[0])
    backend.reset_launches()
    with _forced(routes, TIE) as seen:
        x = tmodel.embed_inputs(ctx, params, cfg, {"tokens": torch.from_numpy(_tokens())})
        h, aux, caches = ttfm.forward(ctx, params, cfg, run, x, torch.arange(S), want_cache=True)
    assert seen["calls"] == len(routes) and not backend.launches
    _close(h, want_h, F32_TOL, "h")
    np.testing.assert_allclose(float(aux), want_aux, rtol=1e-5)
    assert len(caches) == len(want_caches) == 4
    for i, (got, want) in enumerate(zip(caches, want_caches)):
        if i == cfg.attn_offset:           # (k, v) stacked over the periods
            for name, g, w in zip("kv", got, want):
                assert g.shape[0] == periods
                _close(g, w, F32_TOL, f"slot {i} {name}")
        else:                              # ({x, B, C} windows, states)
            for n in ("x", "B", "C"):
                _close(got[0][n], want[0][n], F32_TOL, f"slot {i} conv {n}")
            _close(got[1], want[1], F32_TOL, f"slot {i} state")


@functools.lru_cache(maxsize=None)
def _reference_prefill():
    jcfg, _ = _cfgs(2)
    params, specs = _jparams(2)
    run = _jrun()
    ctx = jmodel.make_ctx(jcfg, run, SIZES, dtype=jnp.float32)
    routes = []
    with jax.threefry_partitionable(False), _reference_routes(routes):
        cache, logits = jmodel.prefill(ctx, params, specs, jcfg, run, {"tokens": _tokens()},
                                       s_max=S + 8)
        logits = np.asarray(logits)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), cache), logits, routes


def test_prefill_regroups_the_caches_as_the_reference():
    """Two periods, f32 compute: the prefill's cache is the reference's
    (attention K/V (periods, B, s_max, Hkv, hd) bf16, zero past the prompt;
    the mixers' windows bf16 and states f32 in rows pi·(per − 1) + mi)."""
    want, want_logits, routes = _reference_prefill()
    _, cfg = _cfgs(2)
    run = _run()
    ctx = tmodel.make_ctx(cfg, run)
    params = convert.tree_to_torch(_jparams(2)[0])
    with _forced(routes, TIE):
        cache, logits = tmodel.prefill(ctx, params, cfg, run,
                                       {"tokens": torch.from_numpy(_tokens())}, s_max=S + 8)
    _close(logits, want_logits, F32_TOL, "logits")
    assert sorted(cache) == ["attn", "ssm"]
    assert sorted(cache["ssm"]) == ["conv_B", "conv_C", "conv_x", "state"]
    zero = tmodel.make_cache(ctx, cfg, B, S + 8, device="cpu")
    for part in ("attn", "ssm"):
        for k, v in cache[part].items():
            assert (v.shape, v.dtype) == (zero[part][k].shape, zero[part][k].dtype), (part, k)
    for k in ("k", "v"):
        _close(cache["attn"][k], want["attn"][k], BF16_TOL, f"attn {k}")
        assert not bool(cache["attn"][k][:, :, S:].any())
    for k in ("conv_x", "conv_B", "conv_C"):
        _close(cache["ssm"][k], want["ssm"][k], BF16_TOL, k)
    _close(cache["ssm"]["state"], want["ssm"]["state"], F32_TOL, "state")
    assert cache["ssm"]["state"].dtype == torch.float32


# ------------------------------------------------------------- the port alone

def test_aux_is_summed_over_moe_layers_and_divided_by_all_layers():
    """aux is the sum of the MoE sublayers' aux losses (2 a period), and the
    loss holds it over all 8 layers, not over the 4 MoE ones."""
    _, cfg = _cfgs(2)
    run = _run()
    params = convert.tree_to_torch(_jparams(2)[0])
    toks = torch.from_numpy(_tokens())
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    block, auxes = tmoe.moe_block, []

    def rec(ctx, p, x, mcfg):
        out, a = block(ctx, p, x, mcfg)
        auxes.append(a)
        return out, a

    tmoe.moe_block = rec
    try:
        with torch.no_grad():
            loss, m = tmodel.train_loss(tmodel.make_ctx(cfg, run), params, cfg, run, batch,
                                        float(B * S))
    finally:
        tmoe.moe_block = block
    assert len(auxes) == 4 and float(m["aux"]) > 0
    assert float(m["aux"]) == pytest.approx(float(sum(auxes)), rel=1e-6)
    ce = float(m["ce_sum"]) / float(B * S)
    assert float(loss) == pytest.approx(ce + float(m["aux"]) / 8, rel=1e-6)
    assert abs(float(loss) - ce - float(m["aux"]) / 4) > 1e-3 * float(m["aux"])


def test_decode_consistent_with_forward():
    """Two periods, f32 compute and f32 caches, capacity for every pair
    (factor E/k): the teacher-forced decode after a prefill gives the
    logits of one forward over the whole sequence (within 1e-4: the chunked
    scan against the recurrence, the flash prefill against the decode's
    attention)."""
    _, cfg = _cfgs(2)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    run = _run()
    ctx = tmodel.make_ctx(cfg, run)
    params = convert.tree_to_torch(_jparams(2)[0])
    toks = torch.from_numpy(_tokens(48, seed=10))
    x = tmodel.embed_inputs(ctx, params, cfg, {"tokens": toks[:, :S]})
    h, _, caches = ttfm.forward(ctx, params, cfg, run, x, torch.arange(S), want_cache=True)
    k, v, conv, st = tmodel.regroup_hybrid_caches(caches, cfg)
    cache = tmodel.make_cache(ctx, cfg, B, 48, dtype=torch.float32, device="cpu")
    cache["attn"]["k"][:, :, :S] = k
    cache["attn"]["v"][:, :, :S] = v
    cache["ssm"].update({f"conv_{n}": conv[n] for n in ("x", "B", "C")}, state=st)
    got = [ttfm.lm_head_logits(ctx, params, cfg, h[:, -1:])]
    for i in range(S, 48):
        _, logits, cache = tmodel.decode_step(ctx, params, cfg, run, cache, toks[:, i:i + 1], i)
        got.append(logits)
    x = tmodel.embed_inputs(ctx, params, cfg, {"tokens": toks})
    h, aux, _ = ttfm.forward(ctx, params, cfg, run, x, torch.arange(48))
    want = ttfm.lm_head_logits(ctx, params, cfg, h[:, S - 1:])
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), want.numpy(), atol=1e-4, rtol=0)
    assert float(aux) > 0
