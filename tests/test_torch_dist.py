"""Data-parallel training of the port over two processes, on the CPU.

The 2-rank scenarios below run once, in two processes of one gloo group
(spawned; each imports this module) with a file store under the test's
temporary directory (no port to clash on between test workers), and write
their results; the tests read them:
  * the boundary merge against cat_tpu.rl.ppo.PPO._boundary_merge under
    shard_map on 2 of the CPU devices conftest.py makes (rtol 1e-6: the
    same float32 formulas, summed in another order);
  * a 2-rank SGD step (half a minibatch a rank, the averaged gradient
    clipped, Adam) against the 1-rank step on the whole minibatch, which
    tests/test_torch_ppo.py holds against the JAX package, to that test's
    bound on the parameters (rtol 1e-6, atol 1e-6: each of the two Adam
    steps moves a weight by at most lr = 3e-4, and where a gradient entry
    is near 0 its update g / (|g| + 1e-5) follows the summation order; the
    largest difference measured is 3e-7) and rtol 1e-6 on the statistics;
  * a whole 2-rank iteration: the state bit for bit equal on both ranks,
    the merged obs normaliser equal to the moments of every raw
    observation of both ranks pooled (1e-6), Episode/count summed, and
    the collectives counted;
  * the checkpoint: rank 0 alone writes, each rank restores its own rows,
    a 2-rank resume is bit for bit, a 1-process restore of a 2-rank
    checkpoint takes every row and starts its generators afresh;
  * the CLI: rank 0 alone writes config.json and metrics.jsonl; train.spawn
    runs it over 2 gloo processes, and so does torchrun; started alone where
    several cards are visible, it spawns one process a card.
"""

import dataclasses
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as tdist
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import _torch_port  # noqa: F401  (one torch thread per test worker)
from cat_tpu.rl.normalize import RmsState as JRms
from cat_tpu.rl.ppo import PPO as JPPO
from cat_tpu.rl.ppo import PpoCfg as JCfg
from cat_tpu_torch import train
from cat_tpu_torch.envs.types import EnvState
from cat_tpu_torch.parallel import distributed, mesh
from cat_tpu_torch.rl import checkpoint
from cat_tpu_torch.rl.normalize import RmsState
from cat_tpu_torch.rl.ppo import PPO, PpoCfg
from chip_smoke import Collectives, Writes

RUN_TIMEOUT_S = 120   # a scenario


# ---- the 2-rank scenarios: ``run`` runs each in both processes of one
# gloo group and saves what it returns as <outdir>/<scenario>.<rank>.pt ----

# 16 global envs of the flat task, 4 steps, 3-step episodes (so episodes
# end and Episode/count is not 0), a global minibatch of 16 (8 a rank)
ARGV = ["--num_envs", "16", "--device", "cpu", "--writer", "none",
        "--override", "num_steps=4", "minibatch_size=16", "save_interval=1",
        "--env_override", "episode_length_s=0.06"]
WORLD = 2
K, NRMAX, NSCAL = 5, 7, 4


def merge_inputs(rank):
    """Per-rank inputs of the boundary merge, from a numpy seed: (obs_rms0,
    obs_rms_l, moms, rmax_l, scal, sum_scaled) as numpy float32."""
    rng = np.random.default_rng(11)
    f = np.float32
    obs_rms0 = (rng.normal(size=K).astype(f), rng.uniform(0.5, 2, K).astype(f),
                f(33.0))
    per_rank = []
    for _ in range(WORLD):
        obs_rms_l = (obs_rms0[0] + 0.1 * rng.normal(size=K).astype(f),
                     obs_rms0[1] * rng.uniform(0.8, 1.2, K).astype(f),
                     f(33.0 + 96.0))
        moms = tuple(tuple(f(v) for v in (rng.normal() * 40, 60 + rng.uniform() * 20,
                                          96.0)) for _ in range(2))
        per_rank.append((obs_rms_l, moms, rng.uniform(0.1, 9, NRMAX).astype(f),
                         rng.uniform(0, 3, NSCAL).astype(f)))
    sum_scaled = np.array([1.0] + [1.0 / WORLD] * (NSCAL - 1), f)
    obs_rms_l, moms, rmax_l, scal = per_rank[rank]
    return obs_rms0, obs_rms_l, moms, rmax_l, scal, sum_scaled


def _tiny_ppo(dist):
    env = types.SimpleNamespace(num_actions=12, num_obs=45,
                                device=torch.device("cpu"))
    return PPO(env, PpoCfg(), torch.Generator().manual_seed(0), dist=dist)


def merge(dist, outdir):
    t = torch.from_numpy
    obs_rms0, obs_rms_l, moms, rmax_l, scal, sum_scaled = merge_inputs(
        dist.rank)
    ppo = _tiny_ppo(dist)
    rms, (vm, rm), rmax, scal_g = ppo._boundary_merge(
        RmsState(*map(torch.tensor, obs_rms0)),
        RmsState(*map(torch.tensor, obs_rms_l)),
        tuple(tuple(map(torch.tensor, m)) for m in moms),
        t(rmax_l), t(scal), t(sum_scaled))
    return {"obs_rms": list(rms), "moms": list(vm) + list(rm),
            "rmax": rmax, "scal": scal_g}


def gather_input(rank):
    """Rows with -0.0, NaN and infinities (float32), ints and bools."""
    x = torch.tensor([[-0.0, float("nan")], [float("inf"), -float("inf")],
                      [1.5, -2.0]]) * (rank + 1)
    return (x, torch.arange(3, dtype=torch.int32) - 7 * rank,
            torch.tensor([True, rank == 1, False]))


def gather(dist, outdir):
    return {"rows": [mesh.gather_rows(t, dist)
                     for t in gather_input(dist.rank)]}


def sgd_minibatches(n=256, steps=2):
    """Two minibatches of n rows and their global advantage moments, from a
    numpy seed (tests/test_torch_ppo.py's shapes)."""
    rng = np.random.default_rng(4)
    out = []
    for _ in range(steps):
        mb = [rng.normal(size=(n, 45)), rng.normal(size=(n, 12)),
              rng.normal(-15.0, 1.0, size=n), rng.normal(size=n),
              rng.normal(size=n), rng.normal(size=n)]
        mb = [np.asarray(x, np.float32) for x in mb]
        adv_mom = np.array([mb[3].mean(), np.square(mb[3]).mean()], np.float32)
        out.append((mb, adv_mom))
    return out


def sgd(dist, outdir):
    """Two Adam steps, each rank on its half of each minibatch."""
    ppo = _tiny_ppo(dist)
    ppo.value_rms = RmsState(*map(torch.tensor, (0.3, 2.0, 500.0)))
    stats = []
    for mb, adv_mom in sgd_minibatches():
        half = mb[0].shape[0] // WORLD
        rows = slice(dist.rank * half, (dist.rank + 1) * half)
        stats.append(ppo.sgd_step([torch.from_numpy(x[rows]) for x in mb],
                                  torch.from_numpy(adv_mom), 3e-4))
    return {"params": ppo.net.state_dict(), "stats": torch.stack(stats)}


def _learner_state(tr):
    """What every rank must agree on after an iteration."""
    opt = tr.ppo.opt.state_dict()["state"]
    return {"params": tr.ppo.net.state_dict(),
            "adam": [opt[i][k] for i in sorted(opt)
                     for k in ("exp_avg", "exp_avg_sq")],
            "obs_rms": list(tr.ppo.obs_rms),
            "value_rms": list(tr.ppo.value_rms),
            "running_max": tr.es.running_max, "lr": tr.ppo.lr}


def iteration(dist, outdir):
    """One whole iteration through the trainer; the raw observations each
    rank saw, its own episode count, the collectives of the iteration."""
    raw, local = [], {}
    real_start = PPO.start

    def start(self, first_obs_raw):
        raw.append(first_obs_raw.clone())
        return real_start(self, first_obs_raw)

    PPO.start = start
    try:
        tr = train.Trainer(train.parse_args(ARGV), dist)
    finally:
        PPO.start = real_start
    real_step, real_drain = tr.env.step, tr.env.drain_metrics

    def step(*a, **k):
        out = real_step(*a, **k)
        raw.append(out[1].clone())
        return out

    def drain(es):
        es, metrics = real_drain(es)
        local.update(metrics)
        return es, metrics

    tr.env.step, tr.env.drain_metrics = step, drain
    with Collectives() as calls:
        metrics = tr.train_iteration()
    n_mb = tr.cfg.num_steps * 8 // (tr.cfg.minibatch_size // WORLD)
    return {"state": _learner_state(tr), "metrics": metrics,
            "raw_obs": torch.cat(raw), "local_metrics": {
                k: float(v) for k, v in local.items()},
            "calls": calls.counts, "n_minibatches": n_mb,
            "epochs": tr.cfg.updates_epochs}


def checkpoints(dist, outdir):
    """ckpt_1 after one iteration; a second iteration to ckpt_2; a fresh
    trainer restored from ckpt_1 runs it again to ckpt_2_resumed."""
    d = os.path.join(outdir, "ckpt")
    args = train.parse_args(ARGV)
    tr = train.Trainer(args, dist)
    tr.train_iteration()
    with Writes(d) as rec:
        path1 = tr.save(os.path.join(d, "ckpt_1"))
    mine = {k: v.clone() for k, v in checkpoint.flatten(
        checkpoint.state_dict(tr.ppo, tr.es)).items()
        if isinstance(v, torch.Tensor)}
    tr.train_iteration()
    tr.save(os.path.join(d, "ckpt_2"))
    fresh = train.Trainer(args, dist)
    fresh.restore(path1)
    restored = checkpoint.flatten(checkpoint.state_dict(fresh.ppo, fresh.es))
    differ = [k for k, v in mine.items() if not torch.equal(v, restored[k])]
    fresh.train_iteration()
    fresh.save(os.path.join(d, "ckpt_2_resumed"))
    return {"writes": rec.paths, "differ_after_restore": differ}


def cli(dist, outdir):
    """train's loop over the group: which files this rank wrote."""
    logdir = os.path.join(outdir, "logs")
    with Writes(logdir) as rec:
        history = train._train(train.parse_args(
            ARGV + ["--max_iterations", "2", "--logdir", logdir,
                    "--run_name", "cli"]), dist)
    return {"writes": sorted(set(rec.paths)), "iterations": len(history)}


SCENARIOS = {f.__name__: f for f in (gather, merge, sgd, iteration,
                                      checkpoints, cli)}


def run(rank, coordinator, outdir):
    """Every scenario, in order, in this rank of a 2-process gloo group."""
    dist = distributed.maybe_initialize(0, coordinator, WORLD, rank,
                                        backend="gloo", device="cpu")
    torch.set_num_threads(1)
    try:
        for name, fn in SCENARIOS.items():
            out = fn(dist, outdir)
            torch.save(out, os.path.join(outdir, f"{name}.{rank}.pt"))
            tdist.barrier()
    finally:
        distributed.close(dist)



# ---- the tests ----


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    distributed.spawn(run, WORLD, (str(out),),
                      coordinator=f"file://{out}/store",
                      timeout=RUN_TIMEOUT_S * len(SCENARIOS))

    def read(name):
        return [torch.load(out / f"{name}.{r}.pt", weights_only=True)
                for r in range(WORLD)]

    read.dir = out
    return read


def _flat(tree):
    return checkpoint.flatten(tree)


def _bitwise_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    return [k for k in fa if not (torch.equal(fa[k], fb[k])
                                  if isinstance(fa[k], torch.Tensor)
                                  else fa[k] == fb[k])]


def test_gather_rows_is_bit_exact(results):
    got = results("gather")
    for rank in range(WORLD):
        for out, parts in zip(got[rank]["rows"],
                              zip(*(gather_input(r) for r in range(WORLD)))):
            want = torch.cat(parts)
            assert out.dtype == want.dtype and out.shape == want.shape
            if out.dtype == torch.float32:
                out, want = out.view(torch.int32), want.view(torch.int32)
            assert torch.equal(out, want)


def _jax_merge():
    """cat_tpu's boundary merge on 2 CPU devices, each given its rank's
    inputs; every output with a leading rank axis."""
    jppo = JPPO(types.SimpleNamespace(num_actions=12, num_obs=45), JCfg(),
                axis_name="env", num_devices=WORLD)
    ins = [merge_inputs(r) for r in range(WORLD)]
    stacked = jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]),
                           *ins)

    def body(obs_rms0, obs_rms_l, moms, rmax_l, scal, sum_scaled):
        one = jax.tree.map(lambda x: x[0], (obs_rms0, obs_rms_l, moms, rmax_l,
                                            scal, sum_scaled))
        rms, (vm, rm), rmax, scal_g = jppo._boundary_merge(
            "env", JRms(*one[0]), JRms(*one[1]), one[2], one[3], one[4],
            one[5])
        return jax.tree.map(lambda x: x[None], (list(rms), list(vm) + list(rm),
                                                rmax, scal_g))

    fn = jax.shard_map(body, mesh=Mesh(np.array(jax.devices()[:WORLD]),
                                       ("env",)),
                       in_specs=P("env"), out_specs=P("env"), check_vma=False)
    return jax.tree.map(np.asarray, jax.jit(fn)(*stacked))


def test_boundary_merge_matches_jax(results):
    got = results("merge")
    rms, moms, rmax, scal = _jax_merge()
    for rank in range(WORLD):
        g = got[rank]
        for a, b in zip(g["obs_rms"], rms):
            np.testing.assert_allclose(a.numpy(), b[rank], rtol=1e-6)
        for a, b in zip(g["moms"], moms):
            np.testing.assert_allclose(a.numpy(), b[rank], rtol=1e-6)
        np.testing.assert_allclose(g["rmax"].numpy(), rmax[rank], rtol=1e-6)
        np.testing.assert_allclose(g["scal"].numpy(), scal[rank], rtol=1e-6)
    assert _bitwise_equal(got[0], got[1]) == []
    # the maxes finished as maxes, the sums as sums
    rmaxes = [merge_inputs(r)[3] for r in range(WORLD)]
    np.testing.assert_array_equal(got[0]["rmax"].numpy(),
                                  np.maximum(*rmaxes))


def test_two_rank_sgd_step_equals_one_rank_on_the_whole_minibatch(results):
    got = results("sgd")
    env = types.SimpleNamespace(num_actions=12, num_obs=45,
                                device=torch.device("cpu"))
    one = PPO(env, PpoCfg(), torch.Generator().manual_seed(0))
    one.value_rms = RmsState(*map(torch.tensor, (0.3, 2.0, 500.0)))
    stats = torch.stack([
        one.sgd_step([torch.from_numpy(x) for x in mb],
                     torch.from_numpy(adv_mom), 3e-4)
        for mb, adv_mom in sgd_minibatches()])
    assert _bitwise_equal(got[0], got[1]) == []
    for name, p in one.net.state_dict().items():
        np.testing.assert_allclose(got[0]["params"][name].numpy(), p.numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(got[0]["stats"].numpy(), stats.numpy(),
                               rtol=1e-6)


def test_iteration_state_is_identical_across_ranks(results):
    got = results("iteration")
    assert _bitwise_equal(got[0]["state"], got[1]["state"]) == []
    assert got[0]["metrics"] == got[1]["metrics"]
    assert all(np.isfinite(v) for v in got[0]["metrics"].values())


def test_merged_obs_normaliser_pools_both_ranks(results):
    got = results("iteration")
    x = np.concatenate([g["raw_obs"].numpy() for g in got]).astype(np.float64)
    # rms_init's prior: count 1, mean 0, var 1
    n = 1.0 + x.shape[0]
    mean = x.sum(0) / n
    var = (1.0 + np.square(x).sum(0)) / n - np.square(mean)
    mean_t, var_t, count_t = (t.numpy() for t in got[0]["state"]["obs_rms"])
    assert float(count_t) == n
    np.testing.assert_allclose(mean_t, mean, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(var_t, var, rtol=1e-6, atol=1e-6)


def test_episode_metrics_merge(results):
    got = results("iteration")
    merged = got[0]["metrics"]
    local = [g["local_metrics"] for g in got]
    assert local[0]["Episode/count"] > 0 and local[1]["Episode/count"] > 0
    assert merged["Episode/count"] == pytest.approx(
        local[0]["Episode/count"] + local[1]["Episode/count"], rel=1e-6)
    # every other metric: the plain mean of the ranks' means
    for k in ("Episode/length", "Episode/reward",
              "Episode_Constraint_violation/cstr_joint_torque"):
        assert merged[k] == pytest.approx((local[0][k] + local[1][k]) / 2,
                                          rel=1e-6), k


def test_iteration_crosses_ranks_by_all_reduce_alone(results):
    got = results("iteration")
    for g in got:
        epochs, n_mb = g["epochs"], g["n_minibatches"]
        # one boundary table, one advantage table an epoch, one gradient
        # buffer a minibatch; no broadcast, nothing else
        assert g["calls"] == {"all_reduce": 1 + epochs * (1 + n_mb),
                              "broadcast": 0, "other": 0}
    assert got[0]["calls"]["all_reduce"] == 26


def test_checkpoint_written_by_rank0_and_resumed_bit_for_bit(results):
    got = results("checkpoints")
    d = results.dir / "ckpt"
    assert got[1]["writes"] == []
    assert got[0]["writes"] == [str(d / "ckpt_1.pt.tmp")]
    for g in got:
        assert g["differ_after_restore"] == []
    a, b = checkpoint.load(str(d / "ckpt_2")), checkpoint.load(
        str(d / "ckpt_2_resumed"))
    assert checkpoint.mismatches(a, b) == []
    saved = checkpoint.load(str(d / "ckpt_1"))
    assert saved["env"]["sim"]["qpos"].shape[0] == 16
    assert saved["ppo"]["next_obs"].shape[0] == 16
    assert all(s.dim() == 2 and s.shape[0] == WORLD
               for s in saved["generators"].values())


def test_one_process_restores_a_two_rank_checkpoint(results, capsys):
    path = str(results.dir / "ckpt" / "ckpt_1")
    tr = train.Trainer(train.parse_args(ARGV))
    fresh = {k: g.get_state() for k, g in tr.generators.items()}
    tr.restore(path)
    assert "another number of processes" in capsys.readouterr().out
    saved = checkpoint.load(path)
    live = checkpoint.state_dict(tr.ppo, tr.es)
    assert checkpoint.mismatches({k: saved[k] for k in ("ppo", "env")},
                                 live) == []
    for k, g in tr.generators.items():
        assert torch.equal(g.get_state(), fresh[k])
    tr.train_iteration()


def test_cli_rank0_alone_writes_the_logs(results):
    got = results("cli")
    run = results.dir / "logs" / "clean_rl" / "Solo12-CaT-Flat-v0" / "cli"
    assert got[1]["writes"] == []
    assert {str(run / f) for f in ("config.json", "metrics.jsonl")} <= set(
        got[0]["writes"])
    assert got[0]["iterations"] == got[1]["iterations"] == 2
    with open(run / "config.json") as f:
        config = json.load(f)
    assert config["devices"] == config["processes"] == 2
    assert config["num_envs"] == 16
    with open(run / "metrics.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2]


def test_spawn_trains_over_two_gloo_processes(tmp_path):
    train.spawn(ARGV + ["--max_iterations", "1", "--logdir",
                           str(tmp_path), "--run_name", "s"], 2, "gloo",
                coordinator=f"file://{tmp_path}/store",
                timeout=RUN_TIMEOUT_S)
    run = tmp_path / "clean_rl" / "Solo12-CaT-Flat-v0" / "s"
    with open(run / "config.json") as f:
        assert json.load(f)["processes"] == 2
    with open(run / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert len(lines) == 1
    # env-steps/s counts the global envs: 4 steps x 16 envs
    m = lines[0]
    assert m["Perf/env_steps_per_sec"] * m["Perf/iter_seconds"] == (
        pytest.approx(4 * 16))
    assert checkpoint.load(str(run / "ckpt_final"))["env"]["mu"].shape == (16,)


def test_state_splits_by_name():
    assert (mesh.BATCHED_ENV_FIELDS | mesh.REPLICATED_ENV_FIELDS
            == set(EnvState._fields))
    assert mesh.is_batched("env.sim.qpos") and mesh.is_batched("ppo.next_obs")
    assert mesh.is_batched("env.com_offset")
    # a 128-wide bias at 128 envs a rank stays replicated
    assert not mesh.is_batched("ppo.net.critic.layers.2.bias")
    assert not mesh.is_batched("env.running_max")
    assert not mesh.is_batched("generators.env")


def test_no_group_without_flags_and_bad_counts_raise():
    dist = distributed.maybe_initialize(3, device="cpu")
    assert (dist.rank, dist.world_size, dist.seed, dist.group) == (0, 1, 3,
                                                                   None)
    with pytest.raises(ValueError, match="does not divide"):
        distributed.local_env_count(15, dataclasses.replace(dist,
                                                            world_size=2))
    with pytest.raises(ValueError, match="num_processes"):
        distributed.maybe_initialize(0, "localhost:1", device="cpu")


def test_torchrun_joins_its_group(tmp_path):
    """Under torchrun (its RANK / WORLD_SIZE / MASTER_* variables) the CLI
    joins torchrun's group: 2 processes on the CPU, one log. Each process
    keeps the one thread torchrun gives it (OMP_NUM_THREADS, unless the
    caller set one): with 4 threads each, six of these runs side by side on
    an 8-core CPU took 185 s each against 12 s."""
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "cat_tpu_torch.train", *ARGV,
         "--max_iterations", "1", "--logdir", str(tmp_path), "--run_name",
         "t"], capture_output=True, text=True, timeout=RUN_TIMEOUT_S,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    run = tmp_path / "clean_rl" / "Solo12-CaT-Flat-v0" / "t"
    with open(run / "config.json") as f:
        assert json.load(f)["processes"] == 2
    with open(run / "metrics.jsonl") as f:
        assert len(f.readlines()) == 1


@pytest.mark.parametrize("omp", [None, "1"])
def test_cpu_process_threads(tmp_path, monkeypatch, omp):
    """A CPU process of a group takes the host's cores / local processes
    threads, unless OMP_NUM_THREADS is set (torchrun sets it): then the
    count it set stays."""
    if omp is None:
        monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    else:
        monkeypatch.setenv("OMP_NUM_THREADS", omp)
    try:
        dist = distributed.maybe_initialize(
            0, f"file://{tmp_path / 'store'}", 1, 0, backend="gloo",
            device="cpu")
        distributed.close(dist)
        assert torch.get_num_threads() == (os.cpu_count() if omp is None
                                           else 1)
    finally:
        torch.set_num_threads(1)


def test_main_spawns_one_process_a_card_where_several_are_visible(
        monkeypatch):
    calls = []
    monkeypatch.setattr(train, "spawn", lambda *a: calls.append(a))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    argv = ["--num_envs", "16"]
    assert train.main(argv) == []
    assert calls == [(argv, 4, None)]
    for flags in (["--single_chip"], ["--device", "cpu"],
                  ["--coordinator", "localhost:1", "--num_processes", "2",
                   "--process_id", "0"]):
        assert not train._spawns(train.parse_args(argv + flags))
    monkeypatch.setenv("RANK", "0")
    assert not train._spawns(train.parse_args(argv))
