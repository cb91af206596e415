"""tune's schedulers and searchers against the JAX package's, on the same
seeds and observations (host code, no device): PBT's explore step, PB2's
GP-UCB explore, BOHB's KDE model, HyperBand's and the median rule's
decisions, and ``DistributeResources`` with ``TPU`` and ``GPU``
swapped (the port splits the card's ``GPU`` with the JAX package's floor
division). The decisions and configs must be equal; the GP's and KDE's
floats at 1e-5."""

import random

import numpy as np
import pytest

from ray_tpu.tune.schedulers import (
    PB2 as JPB2, DistributeResources as JDistribute,
    HyperBandScheduler as JHyperBand, MedianStoppingRule as JMedian,
    TuneBOHB as JBOHB)
from ray_tpu.tune.schedulers.pbt import _explore as jexplore
from ray_tpu.tune.search import sample as jsample
from ray_tpu_torch.tune.schedulers import (
    PB2, DistributeResources, HyperBandScheduler, MedianStoppingRule,
    TuneBOHB)
from ray_tpu_torch.tune.schedulers.pbt import _explore
from ray_tpu_torch.tune.search import sample

RTOL = 1e-5


class _Trial:
    def __init__(self, trial_id, config):
        self.trial_id = trial_id
        self.config = dict(config)
        self.checkpoint = object()


class _Ctl:
    """What the schedulers read of a controller, and what they ask it."""

    def __init__(self, trials):
        self.trials = trials
        self._by_id = {t.trial_id: t for t in trials}
        self.exploits = []

    def get_trial(self, tid):
        return self._by_id.get(tid)

    def is_live(self, tid):
        return tid in self._by_id

    def exploit_trial(self, target, source, new_config):
        self.exploits.append((target.trial_id, source.trial_id,
                              dict(new_config)))
        target.config = dict(new_config)

    def unpause_trial(self, trial):
        pass


def _mutations(s):
    return {"lr": [1e-4, 2e-4, 3e-4, 4e-4], "wd": s.loguniform(1e-5, 1e-1),
            "bs": s.choice([16, 32, 64]), "momentum": s.uniform(0.8, 0.99)}


@pytest.mark.parametrize("resample", [0.0, 0.25, 1.0])
def test_pbt_explore_draws_the_same_config(resample):
    config = {"lr": 2e-4, "wd": 1e-3, "bs": 32, "momentum": 0.9, "k": 7}
    for seed in range(20):
        want = jexplore(config, _mutations(jsample), resample,
                        random.Random(seed))
        got = _explore(config, _mutations(sample), resample,
                       random.Random(seed))
        assert got == want, seed
    # a value not in its list, and a missing key, are resampled alike
    odd = {"lr": 5e-4}
    for seed in range(5):
        assert _explore(odd, _mutations(sample), 0.0, random.Random(seed)) \
            == jexplore(odd, _mutations(jsample), 0.0, random.Random(seed))


def _pb2_run(cls, seed):
    """Six trials reporting 6 iterations of a seeded reward; PB2 exploits
    the bottom quarter with its GP's pick. Returns the exploits."""
    rng = np.random.default_rng(seed)
    sched = cls(metric="score", mode="max", perturbation_interval=2,
                hyperparam_bounds={"lr": [1e-5, 1e-1], "mom": [0.5, 0.99]},
                quantile_fraction=0.25, seed=seed)
    trials = [_Trial(f"t{i}", {"lr": float(10 ** rng.uniform(-5, -1)),
                               "mom": float(rng.uniform(0.5, 0.99))})
              for i in range(6)]
    ctl = _Ctl(trials)
    score = {t.trial_id: 0.0 for t in trials}
    for it in range(1, 7):
        for t in trials:
            score[t.trial_id] += float(-abs(np.log10(t.config["lr"]) + 3)
                                       + rng.normal(0, 0.1))
            sched.on_trial_result(ctl, t, {"training_iteration": it,
                                           "score": score[t.trial_id]})
    return ctl.exploits


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pb2_gp_explore_picks_the_same_configs(seed):
    want, got = _pb2_run(JPB2, seed), _pb2_run(PB2, seed)
    assert len(got) == len(want) > 0
    for (gt, gs, gc), (wt, ws, wc) in zip(got, want):
        assert (gt, gs) == (wt, ws)
        assert sorted(gc) == sorted(wc)
        for k in wc:
            np.testing.assert_allclose(gc[k], wc[k], rtol=RTOL)


def _bohb_run(cls, s, seed):
    space = {"lr": s.loguniform(1e-4, 1e-1), "layers": s.randint(1, 8),
             "act": s.choice(["relu", "gelu", "tanh"])}
    bohb = cls(space, metric="score", mode="max", min_points=6,
               seed=seed)
    rng = np.random.default_rng(seed)
    for budget in (1.0, 3.0):
        for _ in range(12):
            cfg = {k: d.sample(random.Random(int(rng.integers(1 << 30))))
                   for k, d in space.items()}
            bohb.observe(cfg, budget, float(-abs(np.log10(cfg["lr"]) + 2)
                                            + budget))
    return [bohb.suggest(f"t{i}") for i in range(16)]


@pytest.mark.parametrize("seed", [0, 3])
def test_bohb_model_suggests_the_same_configs(seed):
    want, got = _bohb_run(JBOHB, jsample, seed), _bohb_run(TuneBOHB, sample,
                                                          seed)
    for g, w in zip(got, want):
        assert g["act"] == w["act"] and g["layers"] == w["layers"]
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=RTOL)


def _decisions(cls, make, n_trials=6, iters=9):
    sched = make(cls)
    trials = [_Trial(f"t{i}", {}) for i in range(n_trials)]
    ctl = _Ctl(trials)
    for t in trials:
        sched.on_trial_add(ctl, t)
    out = []
    for it in range(1, iters + 1):
        for i, t in enumerate(trials):
            out.append(sched.on_trial_result(
                ctl, t, {"training_iteration": it,
                         "score": float(i * it) / 10}))
    return out


@pytest.mark.parametrize("cls_pair, make", [
    ((JHyperBand, HyperBandScheduler),
     lambda c: c(metric="score", mode="max", max_t=9,
                 reduction_factor=3)),
    ((JMedian, MedianStoppingRule),
     lambda c: c(metric="score", mode="max", grace_period=2,
                 min_samples_required=3)),
], ids=["hyperband", "median"])
def test_scheduler_decisions_match(cls_pair, make):
    jcls, tcls = cls_pair
    want, got = _decisions(jcls, make), _decisions(tcls, make)
    assert got == want
    assert len(set(want)) > 1      # the rule stopped or paused somebody


@pytest.mark.parametrize("total_cpus, total, live", [
    (8, 4, 4), (8, 4, 2), (8, 4, 3), (6, 1, 2), (16, 8, 5), (7.5, 2.5, 2),
    (4, None, 3)])
def test_distribute_resources_splits_gpu_as_jax_splits_tpu(total_cpus,
                                                           total, live):
    trials = [_Trial(f"t{i}", {}) for i in range(live)]
    ctl = _Ctl(trials)
    want = JDistribute(total_cpus=total_cpus, total_tpus=total)(
        ctl, trials[0])
    got = DistributeResources(total_cpus=total_cpus, total_gpus=total)(
        ctl, trials[0])
    assert got == {("GPU" if k == "TPU" else k): v for k, v in want.items()}
    assert "TPU" not in got
