"""The port's sharded CPS steps on gloo CPU processes against the JAX
package's step and the single-process port, at resnet18 / K=8 / 64x64,
global batch 2 labeled + 2 unlabeled (the shapes, seeds and state of
``tests/test_torch_training.py``).

One launch of 4 worker processes (``tests/_torch_dist_worker.py``) runs,
round after round on disjoint ranks: the dp2 x pair2 step on all four; the
DP-2 step and the pair-2 step; the ZeRO step on DP-2 and a DP-2 step whose
BatchNorms see only their own rows; the DP-2 and pair-2 init phases; the
module-level reductions on two shards and the VQ EMA flagship's DP-2
step.

Bounds:
  * every rank's metrics are the same, and the gradients of the ranks that
    hold a model are bitwise the same (their sums);
  * against the single-process port's step: loss terms within 1e-5
    relative, IoUs and code usage within 1e-5, every gradient within 1e-4
    relative L2, BN running stats within 1e-5;
  * against JAX's step, the bounds ``test_one_cps_step_matches_jax`` holds
    the single-process port to: metrics within 1e-4 relative; each
    gradient within 1e-4 relative L2 of JAX's f64 step, and within 1e-4 of
    JAX's f32 step plus that tensor's own f32-to-f64 distance;
  * the DP-2 step with per-rank BatchNorm misses the single-process
    gradients by more than 1e-4 (sync-BN is what holds the bound);
  * the init phases' codebooks, prototype tables and running stats are
    bitwise the single-process init's;
  * ZeRO: each rank holds about half of the replicated Adam's bytes, its
    local Adam got the LR the step wrote, and its parameters after the step
    are bitwise those of a replicated Adam on the same gradients;
  * under ``vq_cfg.ema`` with a restart, after the DP-2 step the cluster
    sizes are bitwise the single process's (the same codes chosen and
    revived), the codebooks and running sums within 1e-5 relative L2 (the
    features and segment sums are added in another order).
"""
import numpy as np
import pytest
import torch

from _torch_dist_worker import run_ema, start
from test_torch_training import (METRICS, MODEL_CFG, NUM_EMB, STEP_KW, TH, _nchw, _port,
                                 _port_step, _rel, jax_one_step, jax_side)  # noqa: F401
from vq_seg_tpu_torch.training import cps_init_phase
from vq_seg_tpu_torch.utils.convert import state_dict_from_flax

torch.set_num_threads(1)

STEPS = ("dp2", "pair2", "dp2pair2", "zero2")
ROUNDS = [[("dp2pair2", "step", 2, 2, [0, 1, 2, 3])],
          [("dp2", "step", 2, 1, [0, 1]), ("pair2", "step", 1, 2, [2, 3])],
          [("zero2", "zero", 2, 1, [0, 1]), ("dp2_local_bn", "local_bn", 2, 1, [2, 3])],
          [("init_dp2", "init", 2, 1, [0, 1]), ("init_pair2", "init", 1, 2, [2, 3])],
          [("reductions", "reductions", 2, 1, [0, 1]), ("ema2", "ema", 2, 1, [2, 3])]]
LOSS_TERMS = ("loss", "cps_loss", "sup_loss_1", "sup_loss_2", "commitment_loss",
              "prototype_loss")


def _grads(state):
    return {f"{i}.{n}": p.grad.clone() for i, model, _ in state.held()
            for n, p in model.named_parameters()}


def _tensors(state, keep):
    return {f"{i}.{k}": v.clone() for i, model, _ in state.held()
            for k, v in model.state_dict().items() if keep(k)}


@pytest.fixture(scope="module")
def launched(jax_side, tmp_path_factory):
    """The workers, started before the JAX steps compile: their start state
    is the scaled post-init state (JAX's step does not enter it)."""
    l_img, l_t, ul = jax_side["batches"][0]
    batch = (_nchw(l_img), torch.from_numpy(l_t).long(), _nchw(ul))
    start_state = _port(jax_side["scaled"])
    post = [m.state_dict() for m in (start_state.model_1, start_state.model_2)]
    pre_state = _port(jax_side["pre"])
    pre = [{k: v.clone() for k, v in m.state_dict().items()}
           for m in (pre_state.model_1, pre_state.model_2)]
    wait = start("steps", 4, str(tmp_path_factory.mktemp("parallel")), model_cfg=MODEL_CFG,
                 state=post, pre_state=pre, step_kw=STEP_KW, batch=batch, rounds=ROUNDS)
    return dict(wait=wait, batch=batch, post=post, pre_state=pre_state)


@pytest.fixture(scope="module")
def runs(launched, jax_side, jax_one_step):
    """The single-process port's step and init phase, and the workers'
    results by scenario: {name: [result of each rank in it]}."""
    single = _port(jax_one_step["scaled"])
    [(metrics, _, _)] = _port_step(single, jax_side["batches"][:1])
    pre_state, batch = launched["pre_state"], launched["batch"]
    cps_init_phase(pre_state, batch[0], batch[1], TH, seed=0)
    ema = run_ema(MODEL_CFG, launched["batch"], STEP_KW)
    by_name = {}
    for res in launched["wait"]():
        for name, out in res.items():
            by_name.setdefault(name, []).append(out)
    return dict(metrics=metrics, grads=_grads(single), ema=ema,
                running=_tensors(single, lambda k: "running" in k),
                init=_tensors(pre_state, lambda k: "codebooks" in k or "prototype_loss" in k
                              or "running" in k),
                start=launched["post"], by_name=by_name)


def _gathered(outs, key):
    """{"i.name": tensor} merged over the ranks that hold it."""
    merged = {}
    for out in outs:
        merged.update(out.get(key, {}))
    return merged


@pytest.mark.parametrize("name", STEPS)
def test_step_matches_single_process_and_jax(runs, jax_one_step, name):
    outs = runs["by_name"][name]
    assert len(outs) == (4 if name == "dp2pair2" else 2)
    for out in outs:
        assert out["differed"] == 0  # the ranks drew the same start: the broadcast changed nothing
        assert out["step"] == 1
        for key in METRICS:  # global metrics: the same on every rank
            np.testing.assert_array_equal(out["metrics"][key].numpy(),
                                          outs[0]["metrics"][key].numpy(), err_msg=key)
    by_model = {}
    for out in outs:  # the replicas of a model hold the same averaged gradients
        by_model.setdefault(out["coords"][1], []).append(out["grad_sums"])
    for sums in by_model.values():
        assert all(s == sums[0] for s in sums)

    m, want = outs[0]["metrics"], runs["metrics"]
    for key in METRICS:
        rtol = 1e-5 if key in LOSS_TERMS else 0.0
        np.testing.assert_allclose(m[key].numpy(), want[key].numpy(), rtol=rtol, atol=1e-5,
                                   err_msg=key)
        np.testing.assert_allclose(m[key].numpy(), jax_one_step["jm"][key], rtol=1e-4,
                                   atol=1e-7, err_msg=key)
    grads = _gathered(outs, "grads")
    assert grads.keys() == runs["grads"].keys()
    jnew, jnew64 = jax_one_step["jnew"], jax_one_step["jnew64"]
    for i, (jv, jg32, jg64) in enumerate(((jnew.variables_1, jnew.opt_state_1, jnew64.opt_state_1),
                                          (jnew.variables_2, jnew.opt_state_2,
                                           jnew64.opt_state_2))):
        jg32 = state_dict_from_flax({**jv, "params": jg32}, NUM_EMB)
        jg64 = state_dict_from_flax({**jv, "params": jg64}, NUM_EMB)
        for key, g in grads.items():
            if not key.startswith(f"{i}."):
                continue
            pname = key[2:]
            assert _rel(g.numpy(), runs["grads"][key].numpy()) <= 1e-4, key
            want64 = jg64[pname].numpy()
            assert _rel(g.numpy(), want64) <= 1e-4, key
            assert _rel(g.numpy(), jg32[pname].numpy()) <= 1e-4 + _rel(jg32[pname].numpy(),
                                                                       want64), key


@pytest.mark.parametrize("name", ("dp2", "pair2", "dp2pair2"))
def test_sync_bn_running_stats_match_single_process(runs, name):
    for out in runs["by_name"][name]:
        for key, t in out["running"].items():
            np.testing.assert_allclose(t.numpy(), runs["running"][key].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=key)


def test_unsynced_bn_would_fail_the_bound(runs):
    """The same DP-2 step with each rank's BatchNorm on its own row: the
    losses are still global, and the gradients miss the bound by far."""
    grads = _gathered(runs["by_name"]["dp2_local_bn"], "grads")
    worst = max(_rel(g.numpy(), runs["grads"][k].numpy()) for k, g in grads.items())
    assert worst > 1e-2, worst
    running = runs["by_name"]["dp2_local_bn"][0]["running"]
    assert max(_rel(t.numpy(), runs["running"][k].numpy()) for k, t in running.items()) > 1e-3


@pytest.mark.parametrize("name", ("init_dp2", "init_pair2"))
def test_init_phase_is_bitwise_the_single_process_one(runs, name):
    outs = runs["by_name"][name]
    seen = set()
    for out in outs:
        for key, t in out["tables"].items():
            np.testing.assert_array_equal(t.numpy(), runs["init"][key].numpy(), err_msg=key)
            seen.add(key)
    assert seen == set(runs["init"])  # both models, codebooks, tables and running stats


def test_zero_shards_the_moments_and_steps_as_adam(runs):
    outs = runs["by_name"]["zero2"]
    total = 0
    for out in outs:
        z = out["zero"]
        replicated = 2 * z["param_bytes"]  # exp_avg and exp_avg_sq of every parameter
        assert 0.4 <= z["opt_bytes"] / replicated <= 0.6, z["opt_bytes"] / replicated
        total += z["opt_bytes"]
        assert z["local_lr"] == [1.0, 1.0]  # the wrapper handed the step's LR to its Adam
    assert abs(total - 2 * outs[0]["zero"]["param_bytes"]) < 4096  # plus Adam's step counters
    # every rank holds every updated parameter, bitwise as a replicated Adam
    # with the step's LR makes them from the start state and these gradients
    grads = _gathered(outs, "grads")
    for i in range(2):
        params = {}
        for key, t in runs["start"][i].items():
            if f"{i}.{key}" in grads:
                params[key] = torch.nn.Parameter(t.clone())
                params[key].grad = grads[f"{i}.{key}"]
        opt = torch.optim.Adam(params.values(), lr=1.0, betas=(0.9, 0.999), eps=1e-8)
        opt.step()
        for out in outs:
            for key, p in params.items():
                np.testing.assert_array_equal(out["zero"]["params_after"][f"{i}.{key}"].numpy(),
                                              p.detach().numpy(), err_msg=key)


def test_module_reductions_see_the_global_batch(runs):
    """Inside ``data_parallel`` over two shards, the k-means inits of a
    codebook and a prototype table and the percentile are bitwise those of
    all the rows without a group; the class means agree to rounding."""
    for out in runs["by_name"]["reductions"]:
        for key in ("codebook", "table", "percentile"):
            np.testing.assert_array_equal(out["sharded"][key].numpy(),
                                          out["single"][key].numpy(), err_msg=key)
        np.testing.assert_allclose(out["sharded"]["class_means"].numpy(),
                                   out["single"]["class_means"].numpy(), rtol=1e-6, atol=1e-7)


def test_ema_codebook_update_matches_single_process(runs):
    """The EMA blend sums the counts and the per-code sums over the ranks,
    and the restart takes its candidates from the gathered rows in the
    global order: the codebook state is the single process's."""
    want = runs["ema"]["codebooks"]
    assert any(k.endswith("cluster_size") for k in want)
    for out in runs["by_name"]["ema2"]:
        assert out["codebooks"].keys() == want.keys()
        for key, t in out["codebooks"].items():
            if key.endswith("cluster_size"):  # the same codes chosen and revived
                np.testing.assert_array_equal(t.numpy(), want[key].numpy(), err_msg=key)
            else:
                assert _rel(t.numpy(), want[key].numpy()) <= 1e-5, key
        np.testing.assert_array_equal(out["metrics"]["code_usage"].numpy(),
                                      runs["ema"]["metrics"]["code_usage"].numpy())
    # a restart happened: some code's cluster size was reset to 1
    revived = [k for k, t in want.items() if k.endswith("cluster_size") and bool((t == 1).any())]
    assert revived
