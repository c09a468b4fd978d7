"""The port's serving entry points against the reference's:
``serve/sampling.py``'s ``split`` and ``randint`` against ``jax.random``,
``PrivacySession.serve_engine``/``generate`` against the reference
session's, ``launch/serve.py`` against the reference's CLI module, and the
quickstart twin (``repro_torch.examples.quickstart``) on the CPU.

``split`` and ``randint`` are integer arithmetic on Threefry: bitwise.
``generate`` draws the reference's prompts bit for bit; its tokens are
held to the reference's on the same weights (reduced qwen2, f32) with
every sampled position's margin asserted, as in
``tests/test_torch_serve.py``.  A replayed synthetic trace (``--device cpu
--smoke``) has the reference's schedule and prefix counts: every request
ends on its length, so these depend on the trace alone, not on the
weights (each side builds its own).  The reference's own
``examples/quickstart.py`` is not run here (minutes of jit); its twin is.
"""
import datetime

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import DPConfig as RefDPConfig
from repro.core.session import PrivacySession as RefSession
from repro.core.session import TrainConfig as RefTrainConfig
from repro.launch import serve as ref_serve
from repro_torch.configs import get_config
from repro_torch.core import DPConfig
from repro_torch.core.session import PrivacySession, TrainConfig
from repro_torch.examples import quickstart
from repro_torch.launch import serve
from repro_torch.serve import sampling as S
from repro_torch.utils.params import params_from_numpy
from test_torch_serve import _assert_margins, _capture

MAX_LEN = 32
SEEDS = (0, 1, 9, 2 ** 31 - 2)
SHAPES = ((1, 1), (2, 3), (3, 7), (4, 16))


@pytest.mark.parametrize("span", [2, 4096, 151_936, 2 ** 31 - 1])
def test_randint_matches_jax(span):
    """``randint`` bitwise to ``jax.random.randint`` (int32), from 0 and
    from a negative low end, over the shapes (1, 1) to (4, 16)."""
    for seed in SEEDS:
        key = S.prng_key(torch.tensor([seed]))
        for shape in SHAPES:
            for lo in (0, -(span // 3)):
                want = np.asarray(jax.random.randint(
                    jax.random.PRNGKey(seed), shape, lo, lo + span))
                got = S.randint(key, shape, lo, lo + span)
                assert got.dtype == torch.int32 and got.shape == shape
                np.testing.assert_array_equal(got.numpy(), want)
    # maxval <= minval returns minval, as JAX's
    got = S.randint(S.prng_key(torch.tensor([3])), (2, 2), 5, 5)
    assert (got == 5).all()


def test_split_matches_jax():
    """``split``'s keys are ``jax.random.split``'s words, bitwise."""
    for seed in SEEDS:
        for num in (2, 5):
            want = np.asarray(jax.random.key_data(jax.random.split(
                jax.random.PRNGKey(seed), num)))
            got = S.split(S.prng_key(torch.tensor([seed])), num)
            assert [[int(a), int(b)] for a, b in got] == want.tolist()


@pytest.fixture(scope="module")
def ref_qwen():
    return RefSession.from_config(
        "qwen2-0.5b", RefDPConfig(engine="nonprivate"),
        RefTrainConfig(seed=0, smoke=True))


@pytest.fixture(scope="module")
def qwen(ref_qwen):
    params = params_from_numpy(jax.tree.map(np.asarray,
                                            ref_qwen.state.params), "cpu")
    return PrivacySession.from_config(
        "qwen2-0.5b", DPConfig(engine="nonprivate"),
        TrainConfig(seed=0, smoke=True), device="cpu", params=params)


def _submitted(engine):
    """Record the prompts ``engine`` is given (a wrapper of ``submit``)."""
    prompts, inner = [], engine.submit

    def submit(request):
        prompts.append(list(request.prompt))
        return inner(request)

    engine.submit = submit
    return prompts


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_generate_matches_reference(qwen, ref_qwen, greedy):
    """The reference's prompts bitwise, its tokens (margins asserted), its
    iterations and occupancy; a second call reuses the engine and gives
    the same tokens."""
    kw = dict(batch=3, prompt_len=4, new_tokens=5, max_len=MAX_LEN,
              greedy=greedy, temperature=0.8, top_k=5)
    ref_eng = ref_qwen.serve_engine(max_slots=3, max_len=MAX_LEN)
    eng = qwen.serve_engine(max_slots=3, max_len=MAX_LEN)
    ref_prompts, prompts = _submitted(ref_eng), _submitted(eng)
    with _capture(ref_eng, np.asarray) as log:
        want = ref_qwen.generate(**kw)
    with _capture(eng, lambda t: t.numpy()):
        got = qwen.generate(**kw)
    want_prompts = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (3, 4), 0, qwen.model_cfg.vocab)).tolist()
    assert prompts == ref_prompts == want_prompts
    assert _assert_margins(log) == 3 * 5
    assert got["generated"] == want["generated"]
    assert all(len(g) == 5 for g in got["generated"])
    assert (got["iterations"], got["occupancy"]) == (want["iterations"],
                                                     want["occupancy"])
    assert set(got) == set(want)
    again = qwen.generate(**kw)
    assert again["generated"] == got["generated"]
    assert qwen.serve_engine(max_slots=3, max_len=MAX_LEN) is eng


def test_cached_engine_serves_params_after_fit():
    """After a fit() step the cached engine serves the new params: the
    same engine object, the tokens of a fresh engine."""
    session = PrivacySession.from_config(
        "qwen2-0.5b", DPConfig(engine="nonprivate"),
        TrainConfig(seed=3, smoke=True, steps=1, n_data=32, physical_batch=8,
                    lr=0.5), device="cpu")
    kw = dict(batch=2, prompt_len=3, new_tokens=6, max_len=16)
    before = session.generate(**kw)["generated"]
    engine = session.serve_engine(max_slots=2, max_len=16)
    old = {k: p.clone() for k, p in session.state.params.items()}
    session.fit()
    assert any(not torch.equal(p, old[k])
               for k, p in session.state.params.items())
    after = session.generate(**kw)["generated"]
    assert session.serve_engine(max_slots=2, max_len=16) is engine
    assert engine.params is session.state.params
    session._serve_engines.clear()          # force a fresh engine and pool
    fresh = session.generate(**kw)["generated"]
    assert after == fresh
    assert after != before                  # the params really changed


@pytest.mark.parametrize("chunk,seed", [(1, 2), (4, 15)])
def test_replay_matches_reference(chunk, seed):
    """The CLI's ``--requests`` mode on the CPU against the reference's
    ``replay`` of the same trace (its smoke config): the same trace
    request for request, the same schedule, prefix counts, prompt lengths
    and finish reasons, and the reference's keys.  Each seed's trace of
    12 has a request whose first token a resident prompt shares (the
    schedule, and so the residents, depend on the chunk)."""
    kw = dict(requests=12, max_slots=4, max_len=MAX_LEN, seed=seed,
              prefill_chunk=chunk)
    vocab = get_config("qwen2-0.5b").reduced().vocab
    ours = serve.synthetic_trace(12, vocab, MAX_LEN, seed=seed)
    theirs = ref_serve.synthetic_trace(12, vocab, MAX_LEN, seed=seed)
    assert [(r.prompt, r.max_new_tokens, r.sampling.seed) for r in ours] == \
        [(r.prompt, r.max_new_tokens, r.sampling.seed) for r in theirs]
    want = ref_serve.replay("qwen2-0.5b", **kw)
    got = serve.main(["--arch", "qwen2-0.5b", "--device", "cpu", "--smoke",
                      "--requests", "12", "--batch", "4", "--max-len",
                      str(MAX_LEN), "--seed", str(seed), "--prefill-chunk",
                      str(chunk)])
    assert set(got) == set(want)
    for k in ("iterations", "occupancy", "prefix_hits",
              "prefix_tokens_shared", "prefix_hit_rate", "generated_tokens",
              "prefill_chunk", "prefix_sharing"):
        assert got[k] == want[k], k
    assert got["prefix_hits"] > 0
    fields = ("rid", "prompt_len", "finish_reason", "prefix_tokens")
    key = lambda r: [r[f] for f in fields]           # noqa: E731
    assert sorted(map(key, got["results"])) == sorted(map(key,
                                                          want["results"]))
    assert all(r["finish_reason"] == "length" for r in got["results"])
    assert [list(r) for r in got["results"]] == \
        [list(r) for r in want["results"]]


def test_cli_mesh_raises_place_cache_error(tmp_path):
    """``--mesh`` builds the session on the mesh executor, whose cache
    placement refuses serving across ranks: the CLI surfaces that error."""
    assert not dist.is_initialized()
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        with pytest.raises(NotImplementedError, match="queue 1 item 5"):
            serve.main(["--arch", "qwen2-0.5b", "--device", "cpu",
                        "--smoke", "--mesh", "1"])
        assert dist.is_initialized()        # the caller's group is kept
    finally:
        dist.destroy_process_group()


def test_generate_without_decode_path_raises_engine_error():
    """A family with no decode path in the port: the CLI's ``generate``
    surfaces ``ServeEngine``'s error before any prompt is drawn."""
    with pytest.raises(ValueError, match="no decode path in the port"):
        serve.generate("vit-base", smoke=True, device="cpu")


def test_quickstart_twin_and_cli_on_its_checkpoint(tmp_path, capsys):
    """The twin trains, checkpoints, restores and decodes on the CPU
    (``QUICKSTART OK``); the CLI serves the same checkpoint with the same
    prompts and gives the same tokens."""
    ckpt = str(tmp_path / "ckpt")
    out = quickstart.main(["--device", "cpu", "--ckpt", ckpt])
    assert "QUICKSTART OK" in capsys.readouterr().out
    assert 0 < out["eps"] <= quickstart.TARGET_EPS
    assert out["restored_step"] == 6 and out["restored_eps"] == out["eps"]
    gen = serve.main(["--arch", "qwen2-0.5b", "--device", "cpu", "--smoke",
                      "--ckpt", ckpt, "--batch", "2", "--prompt-len", "1",
                      "--tokens", "8", "--max-len", "16"])
    assert gen["generated"] == out["generated"]
