"""The executor layer of the port: ``LaunchConfig`` against the reference's,
and data-parallel ``fit()`` in the ``dp`` layout over ``torch.distributed``
(gloo ranks on the CPU, spawned once per world size by the module fixture)
against the reference's local ``fit()`` and the port's own.

Worlds 1, 2 and 4 (mesh ``(1,)``, ``(2,)`` and the ``test`` preset, 2 x 2)
run every engine on the reduced ViT and the reduced qwen2-0.5b for 2 steps
with the reference's initial weights and noise fed in, each fit twice from
a fresh session.  Tolerances: sampler draws (logical batch sizes), σ and ε
EXACT (``float.hex``); params within 2e-5 of the largest entry of the
reference's, the port's ``fit()`` bound (each rank's per-example grads come
from a vmap of its own rows, and the ranks' partial sums are added in
another order than one process adds them); logged losses within 1e-3.
Bitwise: world 1 against the local session, every rank against rank 0, a
rerun against the first run, and the reduced accumulator against a
one-process replay of each rank's rows folded in rank order.
"""
import datetime
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import DPConfig
from repro_torch.core.session import PrivacySession, TrainConfig
from repro_torch.data import (BatchMemoryManager, dataset_for_config,
                              make_sampler)
from repro_torch.kernels import tree_noise
from repro_torch.kernels.noisy_update import step_seeds, update_scalars
from repro_torch.launch.executor import (LaunchConfig, LocalExecutor,
                                         MeshExecutor, build_executor)
from repro_torch.resilience.chaos import digest_params
from repro_torch.utils.params import FlatGradView, params_from_numpy

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ENGINES = ["masked_pe", "masked_fused_stream", "masked_fused",
           "masked_ghost", "masked_bk", "nonprivate"]
ARCHS = ["vit-base", "qwen2-0.5b"]
TRAIN = dict(steps=2, n_data=32, seq_len=16, physical_batch=4, q=0.25,
             target_eps=8.0, lr=0.5, seed=0)
MESHES = {1: (1,), 2: (2,), 4: "test"}
PARAM_TOL = 2e-5
SPAWN_SECONDS = 240


def _train(engine, **over):
    tc = dict(TRAIN, **over)
    if engine == "nonprivate":
        tc["target_eps"] = None
    return tc


def _session(arch, engine, p0, launch=None, **over):
    return PrivacySession.from_config(
        arch, DPConfig(engine=engine, clip_norm=1.0, stream_tile=4),
        TrainConfig(**_train(engine, **over)), device="cpu",
        params={k: v.clone() for k, v in p0.items()}, launch=launch)


def _first_batches(session, physical):
    tc = session.train_cfg
    ds = dataset_for_config(session.model_cfg, tc.n_data, tc.seq_len,
                            seed=tc.seed)
    idx = next(iter(make_sampler(tc.sampler, n=tc.n_data, q=tc.q,
                                 seed=tc.seed, steps=1)))
    return list(BatchMemoryManager(ds.fetch, physical).batches(idx))


def _replay(engine, p0, batches, rows_of, ranks, **over):
    """One process: each rank's rows through the local engine, the
    partial sums folded in rank order."""
    partials = []
    for r in ranks:
        s = _session("vit-base", engine, p0, **over)
        for pb in batches:
            rows = rows_of(r)
            s.accumulate({k: v[rows] for k, v in pb.data.items()},
                         pb.mask[rows])
        partials.append(s.state.grad_acc.clone())
    acc = partials[0].clone()
    for p in partials[1:]:
        acc.add_(p)
    return acc


def _reduced(session, batches):
    for pb in batches:
        session.accumulate(pb.data, pb.mask)
    session._reduce()
    return session.state.grad_acc.clone()


def _rank_body(rank, world, work):
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    launch = LaunchConfig(mesh=MESHES[world])
    out = {"fits": {}, "local": {}, "fold": {}}
    for arch in ARCHS:
        p0, noise = inputs[arch]["params"], inputs[arch]["noise"]
        for engine in ENGINES:
            runs = []
            feed = None if engine == "nonprivate" \
                else (lambda k: noise[k].clone())
            for run in range(2):
                s = _session(arch, engine, p0, launch)
                got = s.fit(noise=feed)
                rec = {"sha": digest_params(s.params),
                       "eps": float(got["final_eps"]).hex(),
                       "sigma": float(got["sigma"]).hex(),
                       "history": got["history"],
                       "launch": s.describe()["launch"]}
                if run == 0 and rank == 0:
                    rec["params"] = {k: v.clone()
                                     for k, v in s.params.items()}
                runs.append(rec)
            out["fits"][arch, engine] = runs
            if world == 1:
                s = _session(arch, engine, p0)
                got = s.fit(noise=feed)
                out["local"][arch, engine] = {
                    "sha": digest_params(s.params),
                    "eps": float(got["final_eps"]).hex(),
                    "launch": s.describe()["launch"],
                    "params": {k: v.clone() for k, v in s.params.items()}}
    # the fold: the reduced accumulator of one logical batch against the
    # one-process replay of each rank's rows, folded in rank order
    p0 = inputs["vit-base"]["params"]
    P = TRAIN["physical_batch"]
    for engine in ENGINES:
        s = _session("vit-base", engine, p0, launch)
        batches = _first_batches(s, P)
        reduced = _reduced(s, batches)
        rec = {"sha": digest_params({"acc": reduced})}
        if rank == 0:
            per = P // world
            replay = _replay(engine, p0, batches,
                             lambda r: slice(r * per, (r + 1) * per),
                             range(world))
            rec["replay_bitwise"] = torch.equal(replay, reduced)
        out["fold"][engine] = rec
    # noise added once: one step with the in-kernel draw against one step
    # with the noise zeroed moves the params by lr * σC/L * z, z the draw
    # of a single-process session's key
    s1 = _session("vit-base", "masked_fused_stream", p0, launch)
    s0 = _session("vit-base", "masked_fused_stream", p0, launch)
    view = FlatGradView.for_params(s1.params)
    single = _session("vit-base", "masked_fused_stream", p0)
    z = tree_noise(single.params, step_seeds(single.state.rng, 0), view=view)
    s1.fit(steps=1)
    s0.fit(steps=1, noise=lambda k: torch.zeros_like(z))
    sc, inv_l, lr, _ = update_scalars(
        s1.dp.noise_multiplier * s1.dp.clip_norm,
        s1.dp.expected_batch_size, TRAIN["lr"], 0.0)
    moved = view.flatten(s0.params) - view.flatten(s1.params)
    want = z * (sc * inv_l * lr)
    out["noise"] = {"ratio": float(moved.norm() / want.norm()),
                    "max_err": float((moved - want).abs().max()
                                     / want.abs().max()),
                    "sha": digest_params(s1.params)}
    # accumulate() + update() by hand reduce as fit() does
    noise = inputs["vit-base"]["noise"]
    by_hand = _session("vit-base", "masked_bk", p0, launch)
    for pb in _first_batches(by_hand, P):
        by_hand.accumulate(pb.data, pb.mask)
    by_hand.update(noise=noise[0].clone())
    fitted = _session("vit-base", "masked_bk", p0, launch)
    fitted.fit(steps=1, noise=lambda k: noise[k].clone())
    out["by_hand"] = {"sha": digest_params(by_hand.params),
                      "fit_sha": digest_params(fitted.params),
                      "eps": float(by_hand.privacy_spent()[0]).hex(),
                      "fit_eps": float(fitted.privacy_spent()[0]).hex()}
    if world == 4:
        # a physical batch of 2 on the 2 x 2 mesh: split over 'data' only,
        # ranks (d, 0) and (d, 1) hold row d, the fold runs over 'data'
        s = _session("vit-base", "masked_fused", p0, launch,
                     physical_batch=2)
        batches = _first_batches(s, 2)
        reduced = _reduced(s, batches)
        group = [rank % 2, rank % 2 + 2]
        replay = _replay("masked_fused", p0, batches,
                         lambda r: slice(r // 2, r // 2 + 1), group,
                         physical_batch=2)
        local = _reduced(_session("vit-base", "masked_fused", p0,
                                  physical_batch=2), batches)
        out["data_only"] = {
            "split": s.executor.split_axes(2),
            "replay_bitwise": torch.equal(replay, reduced),
            "against_local": float((reduced - local).abs().max()
                                   / local.abs().max())}
    if world == 1:
        return out
    # what must raise under more than one rank
    raised = {}
    for name, fn in (
            ("ckpt", lambda: _session("vit-base", "masked_pe", p0, launch)
             .fit(ckpt=os.path.join(work, f"ckpt{rank}"))),
            ("too_few_ranks", lambda: LaunchConfig(
                mesh="production").build_mesh()),
            ("dp_sp", lambda: _session("vit-base", "masked_pe", p0,
                                       LaunchConfig(mesh=MESHES[world],
                                                    layout="dp_sp")))):
        try:
            fn()
            raised[name] = None
        except (NotImplementedError, RuntimeError) as e:
            raised[name] = type(e).__name__
    out["raised"] = raised
    return out


def _rank_main(rank, world, work):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(work, f'store{world}')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=SPAWN_SECONDS))
    try:
        torch.save(_rank_body(rank, world, work),
                   os.path.join(work, f"world{world}.rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _reference(arch, engine, p0=None, noise=None):
    """The reference's local fit, or (with ``p0`` None) its initial
    weights and the noise its update draws for each step."""
    import jax
    from repro.core import DPConfig as RefDPConfig
    from repro.core.session import PrivacySession as RefSession
    from repro.core.session import TrainConfig as RefTrainConfig
    from repro.utils.params import FlatGradView as RefView
    from repro_torch.utils.params import flatten_tree
    ref = RefSession.from_config(
        arch, RefDPConfig(engine=engine, clip_norm=1.0, stream_tile=4),
        RefTrainConfig(**_train(engine)))
    if p0 is None:
        view = RefView.for_tree(ref.state.params)
        key, draws = ref.state.rng, []
        for _ in range(TRAIN["steps"]):
            key, nkey = jax.random.split(key)
            draws.append(torch.tensor(np.asarray(view.noise(nkey))))
        return params_from_numpy(jax.tree.map(np.asarray, ref.state.params),
                                 "cpu"), draws
    out = ref.fit()
    return {"sigma": float(out["sigma"]).hex(),
            "eps": float(out["final_eps"]).hex(),
            "history": out["history"],
            "params": {k: np.asarray(v) for k, v in flatten_tree(
                jax.tree.map(np.asarray, ref.state.params)).items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn worlds 1, 2 and 4 at once; compute the reference's local fits
    while they run; return both."""
    work = str(tmp_path_factory.mktemp("dp"))
    inputs = {}
    for arch in ARCHS:
        params, noise = _reference(arch, "masked_pe")
        inputs[arch] = {"params": params, "noise": noise}
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    ctxs = {w: mp.start_processes(_rank_main, args=(w, work), nprocs=w,
                                  join=False, start_method="spawn")
            for w in MESHES}
    try:
        ref = {(a, e): _reference(a, e, inputs[a]["params"])
               for a in ARCHS for e in ENGINES}
        import time
        deadline = time.monotonic() + SPAWN_SECONDS
        for ctx in ctxs.values():
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    raise TimeoutError("dp worlds did not finish")
    finally:
        for ctx in ctxs.values():
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
    worlds = {w: [torch.load(os.path.join(work, f"world{w}.rank{r}.pt"),
                             weights_only=False)
                  for r in range(w)] for w in MESHES}
    return {"worlds": worlds, "ref": ref, "inputs": inputs}


# -- LaunchConfig against the reference's (no ranks needed) ------------------

LAUNCH_CASES = [
    dict(), dict(mesh="local"), dict(mesh="test"), dict(mesh="production"),
    dict(mesh="production-multipod"), dict(mesh=(8,)), dict(mesh=(4, 2)),
    dict(mesh=(2, 4, 2)), dict(mesh=(3, 5), axes=("x", "y")),
    dict(mesh="test", layout="dp_sp"), dict(mesh=(2, 2), layout="2d"),
]
BAD_LAUNCH = [dict(mesh="bogus"), dict(mesh=(2, 2, 2, 2)),
              dict(mesh="test", layout="bogus"), dict(layout="bogus")]


@pytest.mark.parametrize("kw", LAUNCH_CASES, ids=str)
def test_launch_config_resolves_as_the_reference(kw):
    from repro.launch.executor import LaunchConfig as RefLaunchConfig
    port, ref = LaunchConfig(**kw), RefLaunchConfig(**kw)
    assert port.validate() == port
    assert port.resolved() == ref.resolved()
    assert port.mesh_shape() == ref.mesh_shape()
    assert port.is_local == ref.is_local


@pytest.mark.parametrize("kw", BAD_LAUNCH, ids=str)
def test_launch_config_rejects_bad_input_as_the_reference(kw):
    from repro.launch.executor import LaunchConfig as RefLaunchConfig
    with pytest.raises(ValueError) as ref_err:
        RefLaunchConfig(**kw).validate()
    with pytest.raises(ValueError) as port_err:
        LaunchConfig(**kw).validate()
    assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(ValueError):
        build_executor(LaunchConfig(**kw))


def test_executor_dispatch_and_what_is_not_ported():
    from repro.launch.executor import LocalExecutor as RefLocal
    assert isinstance(build_executor(None), LocalExecutor)
    assert isinstance(build_executor(LaunchConfig(mesh="local")),
                      LocalExecutor)
    assert build_executor(None).describe() == RefLocal().describe()
    with pytest.raises(ValueError, match="local"):
        MeshExecutor(LaunchConfig())
    with pytest.raises(ValueError, match="sharding rules"):
        MeshExecutor(LaunchConfig(mesh=(3, 5), axes=("x", "y")))
    for layout in ("dp_sp", "2d"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_executor(LaunchConfig(mesh="test", layout=layout))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            PrivacySession.from_config(
                "vit-base", train_cfg=TrainConfig(steps=1), device="cpu",
                launch=LaunchConfig(mesh="test", layout=layout))
    with pytest.raises(NotImplementedError, match="pe_bf16"):
        build_executor(LaunchConfig(pe_bf16=True))
    # the pod presets resolve, and building them without their ranks raises
    for preset, n in (("production", 256), ("production-multipod", 512)):
        with pytest.raises(RuntimeError, match=f"needs {n} ranks"):
            LaunchConfig(mesh=preset).build_mesh()
        with pytest.raises(RuntimeError, match="never cut"):
            build_executor(LaunchConfig(mesh=preset))


def test_local_session_is_unchanged():
    """Without ``launch`` the executor moves batches whole and the
    reduction is the identity: the same object back, not a copy."""
    s = PrivacySession.from_config(
        "vit-base", DPConfig(engine="masked_pe"),
        TrainConfig(steps=1, n_data=16, physical_batch=4), device="cpu")
    acc = s.state.grad_acc
    assert s.executor.reduce(acc) is acc
    assert s.executor.local_rows(4) == slice(0, 4)
    assert s.describe()["launch"] == {"executor": "local"}


# -- data-parallel fits over gloo ranks --------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", [2, 4])
def test_dp_fit_matches_reference_local_fit(runs, world, arch, engine):
    want = runs["ref"][arch, engine]
    ranks = [r["fits"][arch, engine] for r in runs["worlds"][world]]
    got = ranks[0][0]
    assert got["sigma"] == want["sigma"] and got["eps"] == want["eps"]
    assert got["launch"] == {"executor": "mesh",
                             "mesh": LaunchConfig(
                                 mesh=MESHES[world]).mesh_shape(),
                             "layout": "dp"}
    for g, w in zip(got["history"], want["history"], strict=True):
        assert g["logical_batch"] == w["logical_batch"]
        assert g["eps"] == w["eps"]
        assert g["loss"] == pytest.approx(w["loss"], abs=1e-3)
    scale = max(float(np.abs(v).max()) for v in want["params"].values())
    local = runs["worlds"][1][0]["local"][arch, engine]["params"]
    p0 = runs["inputs"][arch]["params"]
    moved = 0.0
    for name, w in want["params"].items():
        p = got["params"][name].numpy()
        np.testing.assert_allclose(p, w, rtol=0, atol=PARAM_TOL * scale,
                                   err_msg=name)
        np.testing.assert_allclose(p, local[name].numpy(), rtol=0,
                                   atol=PARAM_TOL * scale, err_msg=name)
        moved = max(moved, float(np.abs(w - p0[name].numpy()).max()))
    assert moved > 1e-3                  # the steps really moved the weights
    # every rank holds the same bits, and a rerun reproduces them
    for rank_runs in ranks:
        for run in rank_runs:
            assert run["sha"] == got["sha"] and run["eps"] == got["eps"]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_dp_is_bitwise_the_local_session(runs, arch, engine):
    rank0 = runs["worlds"][1][0]
    local, (dp, rerun) = rank0["local"][arch, engine], \
        rank0["fits"][arch, engine]
    assert dp["sha"] == local["sha"] == rerun["sha"]
    assert dp["eps"] == local["eps"]
    assert local["launch"] == {"executor": "local"}
    assert dp["launch"] == {"executor": "mesh", "mesh": {"data": 1},
                            "layout": "dp"}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("world", [2, 4])
def test_fold_equals_one_process_rank_order_replay(runs, world, engine):
    ranks = [r["fold"][engine] for r in runs["worlds"][world]]
    assert ranks[0]["replay_bitwise"]
    assert all(r["sha"] == ranks[0]["sha"] for r in ranks)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_noise_is_added_once(runs, world):
    """A dp step moves the params from the noiseless step by the
    single-process lr·σC/L·z, not by √N or N times it: every rank draws
    the same key once, after the reduction."""
    ranks = runs["worlds"][world]
    for r in ranks:
        assert r["noise"]["ratio"] == pytest.approx(1.0, abs=1e-4)
        assert r["noise"]["max_err"] < 1e-4
        assert r["noise"]["sha"] == ranks[0]["noise"]["sha"]


@pytest.mark.parametrize("world", [1, 2, 4])
def test_update_by_hand_reduces_as_fit_does(runs, world):
    ranks = [r["by_hand"] for r in runs["worlds"][world]]
    for r in ranks:
        assert r["sha"] == r["fit_sha"] == ranks[0]["sha"]
        assert r["eps"] == r["fit_eps"]


def test_batch_split_over_data_only_counts_each_example_once(runs):
    for r in runs["worlds"][4]:
        got = r["data_only"]
        assert got["split"] == ("data",)
        assert got["replay_bitwise"]
        assert got["against_local"] < PARAM_TOL


@pytest.mark.parametrize("world", [2, 4])
def test_ranked_runs_refuse_what_is_not_ported(runs, world):
    for r in runs["worlds"][world]:
        assert r["raised"] == {"ckpt": "NotImplementedError",
                               "too_few_ranks": "RuntimeError",
                               "dp_sp": "NotImplementedError"}


# -- the CLI under torchrun, and the import rule -----------------------------

def test_cli_under_torchrun_on_two_gloo_ranks():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--smoke", "--mesh", "2", "--steps", "2",
         "--n-data", "32", "--physical", "4", "--q", "0.25", "--describe"],
        capture_output=True, text=True, env=env, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(x) for x in proc.stdout.splitlines()
             if x.startswith("{")]
    described = [x for x in lines if "launch" in x]
    finals = [x for x in lines if "final" in x]
    assert len(described) == 1 and len(finals) == 1, proc.stdout
    assert described[0]["launch"] == {"executor": "mesh",
                                      "mesh": {"data": 2}, "layout": "dp"}
    assert finals[0]["final_eps"] > 0


def test_cli_refuses_layouts_and_a_missing_process_group():
    from repro_torch.launch import train
    for layout in ("dp_sp", "2d"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            train.main(["--device", "cpu", "--smoke", "--mesh", "2",
                        "--layout", layout])
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--smoke", "--mesh", "2", "--steps", "1"],
        capture_output=True, text=True, env=dict(env, PYTHONPATH=SRC),
        timeout=120)
    assert proc.returncode != 0 and "torchrun" in proc.stderr
    assert not proc.stdout.strip()


def test_executor_and_collectives_import_no_jax():
    code = ("import sys; import repro_torch.launch.executor, "
            "repro_torch.utils.collectives, repro_torch.launch.train; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=dict(os.environ, PYTHONPATH=SRC),
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
