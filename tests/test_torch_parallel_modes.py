"""The eleven training modes other than ``cps`` (``sup`` and the ten variant
steps) on data-parallel meshes of gloo CPU processes, against the
single-process port step and, for ``unimatch``, against the JAX package's
step; the cross-item operations at every layout; the ``model`` axis as
replicas; ZeRO-1 with gradient accumulation.  Sizes: each mode's shipped
config cut to resnet18, K=8, 64x64, global batch 4 + 4
(``tests/_parallel_modes.py``).

One launch of 4 worker processes (``tests/_torch_dist_worker.py``) runs,
round after round on disjoint ranks: the eleven DP-2 steps (six on ranks
0-1, five on ranks 2-3; the mesh's first rank then runs the single-process
step from the same start and compares); ``plaincps`` on a 2 x 2 mesh (the
``model`` axis holding replicas); the cross-item operations on DP-2 and
ZeRO-1 with accumulation on DP-2; the cross-item operations on DP-4.

Bounds:
  * each mode's DP-2 step against the single-process step on the same
    state, batch and draws, in f64 (``_parallel_modes.MODES`` says why):
    loss terms within 1e-5 relative, IoUs within 1e-5, every gradient
    within 1e-4 relative L2, every BN running statistic within 1e-5
    relative L2; every rank's metrics the same;
  * ``unimatch``'s DP-2 step (f64) against the JAX package's f64 step from
    the same variables, boxes and dropout masks: the loss terms within
    1e-7 relative and every gradient within 1e-6 relative L2, the bounds
    of ``tests/test_torch_unimatch.py``;
  * CutMix (a value and its gradient), the supervised-contrastive loss and
    the diagonal-cosine loss, each with one and two items per rank on
    DP-2 and DP-4 (CutMix's boundary rows, ``supcon_loss``'s two items on
    one rank and on two): values within 1e-12 relative of the single
    process and input gradients within 1e-12; integer CutMix and the
    sharded draws exact;
  * after a ``plaincps`` step on the 2 x 2 mesh, the four ranks'
    parameters are bitwise equal, and bitwise those of the DP-2 step;
  * ZeRO-1 over ``MultiStepAdam`` (k=2): parameters bitwise those of a
    replicated ``MultiStepAdam`` on the same gradients after 2 and 4
    micro-steps; the consolidated state after 3 micro-steps equal to the
    replicated one (``mini_step`` 1, every ``acc_grads`` entry); a ZeRO
    resume and a single-process resume from it, bitwise the unbroken run.
"""
import numpy as np
import pytest
import torch

import _parallel_modes as pm
from _torch_dist_worker import start

torch.set_num_threads(1)

HALF_1 = ("sup", "reptcps", "objcps", "easyhard", "supconcps", "unimatch")
HALF_2 = ("plaincps", "vqpt", "angularv3", "semiweed", "salientcps")
ROUNDS = [[("dpA", [("mode", m) for m in HALF_1], 2, 1, [0, 1]),
           ("dpB", [("mode", m) for m in HALF_2], 2, 1, [2, 3])],
          [("rep", [("mode", "plaincps", False)], 2, 2, [0, 1, 2, 3])],
          [("cross2", [("cross",)], 2, 1, [0, 1]), ("zero", [("zero_accum",)], 2, 1, [2, 3])],
          [("cross4", [("cross",)], 4, 1, [0, 1, 2, 3])]]
TERMS = ("loss", "sup_loss", "loss_u_1", "loss_u_2", "loss_u_fp")


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def unimatch_jax():
    """JAX's ``unimatch`` variables drawn from a numpy seed (the start of
    every ``unimatch`` run here), the dropout masks and CutMix boxes every
    run takes, drawn for the global batch."""
    import jax
    import jax.numpy as jnp

    from _port_helpers import to_np
    from _seeded_flax import seeded_variables
    from vq_seg_tpu.models.networks import make_model as jax_make_model
    from vq_seg_tpu_torch.utils.convert import state_dict_from_flax

    batch = pm.global_batch()
    jmodel = jax_make_model({"name": "unimatch", "params": pm.UNIMATCH_PARAMS})
    v = to_np(seeded_variables(jmodel, (jnp.asarray(_nhwc(batch[0])),), train=True))
    # flax's own init scale (lecun normal, variance 1 / fan-in) in place of
    # the seeded He scale (2 / fan-in), whose logits at this depth saturate
    # every softmax, as in the JAX driver's state that the unimatch file uses
    v = jax.tree_util.tree_map_with_path(
        lambda path, a: a * np.float32(np.sqrt(0.5)) if path[-1].key == "kernel" else a, v)
    rng = np.random.default_rng(3)
    keep = lambda *shape: torch.from_numpy(rng.uniform(size=shape) < 0.5)  # noqa: E731
    n = pm.B
    aspp, aspp_fp = keep(n, 256, 4, 4), keep(2 * n, 256, 4, 4)
    fps = [keep(n, 64, 32, 32), keep(n, 512, 4, 4)]
    boxes = []
    from vq_seg_tpu_torch.data.augmentations import make_cutout_mask

    g = torch.Generator().manual_seed(4)
    boxes = [make_cutout_mask(g, (pm.HW, pm.HW), 0.5) for _ in range(2)]
    masks = (boxes[0], boxes[1], {tuple(aspp.shape): aspp, tuple(aspp_fp.shape): aspp_fp}, fps)
    # JAX's draw order: the labeled pass's ASPP, the perturbation's two, the
    # fp pass's ASPP over 2N, the two mixes' ASPP (one key: the first mask)
    replay = [_nhwc(m) for m in (aspp, fps[0], fps[1], aspp_fp, aspp, aspp)]
    return dict(jmodel=jmodel, variables=v, start={0: state_dict_from_flax(v, None)},
                masks=masks, replay=replay, batch=batch)


@pytest.fixture(scope="module")
def launched(unimatch_jax, tmp_path_factory):
    wait = start("modes", 4, str(tmp_path_factory.mktemp("parallel_modes")),
                 batch=pm.global_batch(), rounds=ROUNDS,
                 start={"unimatch": unimatch_jax["start"]},
                 masks={"unimatch": unimatch_jax["masks"]}, keep_grads=("unimatch",))
    return wait


@pytest.fixture(scope="module")
def jax_unimatch_step(unimatch_jax, launched):
    """JAX's f64 ``unimatch`` step (the head's kernel scaled as the port's
    runs scale it), computed while the workers run."""
    from unittest import mock

    import jax

    from _port_helpers import wide
    from _slice_parity import jax_f64_one_model_step
    from vq_seg_tpu.training import supervised as jsup
    from vq_seg_tpu.training import variants as jvariants
    from vq_seg_tpu_torch.utils import convert
    from vq_seg_tpu_torch.utils.convert import state_dict_from_flax

    v = jax.tree_util.tree_map(np.array, unimatch_jax["variables"])
    head = v["params"]["segmentation_head"]["ConvPad_0"]["Conv_0"]
    head["kernel"] = head["kernel"] * np.float32(pm.UNIMATCH_HEAD_SCALE)
    post = jsup.TrainState(variables=v, opt_state=None, step=np.zeros((), np.int32))
    l_img, l_t, ul = unimatch_jax["batch"][:3]
    box_queue = [np.asarray(b.numpy()) for b in unimatch_jax["masks"][:2]]
    with mock.patch.object(jvariants, "make_cutout_mask", lambda *a: box_queue.pop(0)):
        new64, m64 = jax_f64_one_model_step(
            lambda tx: jvariants.make_unimatch_train_step(unimatch_jax["jmodel"], tx,
                                                          num_classes=3),
            post, (_nhwc(l_img), l_t.numpy(), _nhwc(ul), np.asarray(jax.random.PRNGKey(7))),
            replay=unimatch_jax["replay"])
    assert not box_queue
    with mock.patch.object(convert, "_t", lambda a: torch.tensor(np.asarray(a, np.float64))):
        grads = state_dict_from_flax({**wide(v), "params": new64.opt_state}, None)
    return dict(metrics=m64, grads=grads)


@pytest.fixture(scope="module")
def results(launched, jax_unimatch_step):
    """{scenario: [the result of each rank in it]} (JAX's step computed
    first, while the workers run)."""
    by_name = {}
    for res in launched():
        for name, out in res.items():
            by_name.setdefault(name, []).append(out)
    return by_name


def _mode_runs(results, mode):
    return results[f"{'dpA' if mode in HALF_1 else 'dpB'}/{mode}"]


@pytest.mark.parametrize("mode", HALF_1 + HALF_2)
def test_dp2_step_matches_single_process(results, mode):
    outs = _mode_runs(results, mode)
    assert len(outs) == 2 and all(o["step"] == 1 for o in outs)
    for out in outs:  # the global metrics, the same on every rank
        for key, v in out["metrics"].items():
            torch.testing.assert_close(v, outs[0]["metrics"][key], rtol=0, atol=0)
    [cmp] = [o["compare"] for o in outs if "compare" in o]
    assert all(cmp["keys"]), cmp["keys"]
    assert cmp["n_grads"] > 0 and cmp["n_running"] > 0
    assert cmp["loss"] <= 1e-5, cmp
    assert cmp["iou"] <= 1e-5, cmp
    assert cmp["grads"] <= 1e-4, cmp
    assert cmp["running"] <= 1e-5, cmp
    want = [o["single_metrics"] for o in outs if "single_metrics" in o][0]
    assert all(np.isfinite(float(want[k])) for k in cmp["terms"])
    if mode == "unimatch":  # every term sees confident pixels
        assert all(float(want[k]) > 0 for k in TERMS)


def test_unimatch_dp2_step_matches_jax(results, jax_unimatch_step):
    outs = _mode_runs(results, "unimatch")
    got = outs[0]["metrics"]
    want = jax_unimatch_step["metrics"]
    for k in TERMS:
        assert abs(float(got[k]) / float(want[k]) - 1) <= 1e-7, k
    np.testing.assert_allclose(got["iou_list"].numpy(), want["iou_list"], atol=1e-9)
    [grads] = [o["grads"] for o in outs if "grads" in o]
    wg = jax_unimatch_step["grads"]
    names = {name.split(".", 1)[1]: g for name, g in grads.items()}
    assert len(names) > 0 and set(names) <= set(wg)
    for name, g in names.items():
        assert pm.rel(g, wg[name]) <= 1e-6, name


CROSS = [f"{op}_{n}" for op in ("cutmix", "supcon", "dc") for n in ("r", "2r")]


@pytest.mark.parametrize("layout", ["cross2", "cross4"])
@pytest.mark.parametrize("case", CROSS)
def test_cross_item_operations_match_single_process(results, layout, case):
    outs = results[f"{layout}/cross"]
    r = len(outs)
    assert r == int(layout[-1])
    op, per = case.split("_")
    key = f"{op}_{r if per == 'r' else 2 * r}"
    for out in outs:
        res = out[key]
        assert abs(res["value"] - res["single"]) <= 1e-12 * max(abs(res["single"]), 1e-30), res
        assert res["grad_err"] <= 1e-12, res
    if op == "supcon":  # a loss that reads items 0 and 1 only
        assert outs[0][key]["single"] > 0


@pytest.mark.parametrize("layout", ["cross2", "cross4"])
def test_integer_cutmix_and_sharded_draws_are_exact(results, layout):
    for out in results[f"{layout}/cross"]:
        r = 2 if layout == "cross2" else 4
        for n in (r, 2 * r):
            assert out[f"cutmix_labels_{n}"] and out[f"draw_{n}"]


def test_model_axis_holds_replicas(results):
    """``plaincps`` on data 2 x model 2: the two ranks of each data index
    run the same shard over their own data group; all four end with the
    DP-2 step's parameters, bitwise."""
    reps = results["rep/plaincps"]
    dp = _mode_runs(results, "plaincps")
    assert sorted(o["coords"] for o in reps) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert len({o["digest"] for o in reps + dp}) == 1
    for out in reps:
        torch.testing.assert_close(out["metrics"]["loss"], dp[0]["metrics"]["loss"], rtol=0,
                                   atol=0)


@pytest.mark.parametrize("micro_steps", [2, 4])
def test_zero_with_accumulation_is_bitwise_multistep_adam(results, micro_steps):
    for out in results["zero/zero_accum"]:
        assert out["bitwise"][micro_steps]
        assert 0 < out["local_accs"] < 8  # each rank accumulates its own share only


def test_zero_with_accumulation_consolidates_the_replicated_state(results):
    outs = results["zero/zero_accum"]
    [main] = [o for o in outs if "state_equal" in o]
    assert main["mini_step"] == (1, 1)
    assert main["state_equal"]
    assert sum(o["local_accs"] for o in outs) == 8  # the four layers' weights and biases


@pytest.mark.parametrize("where", ["zero", "rep"])
def test_zero_with_accumulation_resumes_mid_accumulation(results, where):
    for out in results["zero/zero_accum"]:
        assert out[f"resume_{where}"]
