"""Variant training steps, counterparts of every step of the JAX
package's ``training/variants.py``: ``make_rept_cps_train_step``,
``make_plain_cps_train_step``, ``make_objloss_cps_train_step``,
``make_vqpt_cps_train_step``, ``make_easyhard_cps_train_step``,
``make_angularv3_cps_train_step``, ``make_supcon_cps_train_step``,
``make_semiweed_train_step``, ``make_unimatch_train_step`` and
``make_salient_cps_train_step``.

The ``reptcps`` step is CPS for the ``(x, gt, percent)``-signature
networks, whose prototype loss keeps the rows below the entropy
``percent``-ile (``vqreptunet1x1`` and its siblings).  One step, as in the
JAX package:

  * two pseudo passes over the unlabeled batch, each model in eval mode
    under ``torch.no_grad``; their argmax labels (integers, not score
    maps) feed the *other* model's unsupervised pass;
  * four train-mode passes in the order sup 1, sup 2, unsup 1, unsup 2,
    each with ``drop_percent`` as the entropy percent;
  * CPS targets are entropy-regularized pseudo-labels
    (``regularized_pseudo``): pixels whose softmax entropy is at least the
    ``drop_percent``-ile become 255 (ignored);
  * the CPS and supervised losses are the criterion alone (no 0.5 * CE),
    the commitment and prototype losses weighted; one backward through
    both models, then each Adam update at ``lr = schedule(step)``;
  * f32 throughout (the JAX driver runs this family without its bf16
    context): the step runs under ``device.full_f32``, so cuDNN does not
    round its convolutions to TF32 on the card; the metrics stay on the
    device.

The plain and object-loss steps are CPS for plain-forward networks
(``forward(x, train=...)``): no pseudo passes, four train-mode passes (sup
1, sup 2, unsup 1, unsup 2) and each model's plain argmax as the other's
target.  They too run in f32 under ``device.full_f32``.

The ``vqpt`` and ``easyhard`` steps are CPS for the ``(x, gt)``-signature
networks (``vqptunet``, ``vqeuptunet``, ``vqnedptunet``, ``vqashunet``,
``vqashunetv2``): two eval-mode argmax pseudo passes, whose labels are
the *other* model's ``gt`` in its unlabeled train pass, then four
train-mode passes, all in f32 under ``device.full_f32``.  ``easyhard``
takes its pseudo-labels from an easy (flipped) view and trains on a hard
(CutMix) view, with the mask and the flip given to the step.

The ``angularv3`` step is CPS for ``vqreptunetangularv3`` (``(x, pred,
split, th)``): the eval pseudo passes give score maps, which are the other
model's ``pred`` on the ``"unlabeled"`` split at the epoch's threshold;
the CPS targets keep the pixels whose largest score (no further softmax)
exceeds it.  The ``supconcps`` step is the ``vqpt`` step's CPS for
``supconvqunet`` with its contrastive loss on the two labeled passes.  The
``semiweed`` step trains one ``semiweednet``: CE of the labeled pass and
the diagonal-cosine loss between the MLP projections of two flipped,
overlapping crops of the unlabeled batch, with the ASPP dropout masks
given to it.  The ``unimatch`` step trains one ``unimatch`` network
against its own eval-mode teacher: two CutMix views of the unlabeled batch
and its feature-perturbed view, with the boxes and dropout masks given to
it.  The ``salientcps`` step is plain CPS of two ``VQUnetwithSalientloss``
networks plus their saliency decoders' MSE against the given maps.  All
run in f32 under ``device.full_f32``.
"""
from __future__ import annotations

import torch

from ..data.augmentations import cutmix
from ..device import full_f32
from ..losses import cross_entropy_loss, dc_loss
from ..metrics.measurement import confusion_matrix, miou
from ..models.layers import resize_nearest_exact
from ..models.modules.prototype import percentile
from ..utils.train_tools import set_lr
from .cps import CPSTrainState
from .supervised import TrainState

IGNORE = 255


@torch.no_grad()
def regularized_pseudo(pred: torch.Tensor, drop_percent) -> torch.Tensor:
    """(N, C, H, W) scores -> (N, H, W) argmax labels, with the pixels
    whose softmax entropy is at least the ``drop_percent``-ile of the
    batch's entropies set to 255."""
    prob = torch.softmax(pred.float(), dim=1)
    label = torch.argmax(prob, dim=1)
    entropy = -torch.sum(prob * torch.log(prob + 1e-10), dim=1)
    thresh = percentile(entropy, drop_percent)
    return torch.where(entropy >= thresh, torch.full_like(label, IGNORE), label)


def _update(state: CPSTrainState, loss, pred_sup_1, l_target, num_classes: int, **terms):
    """One backward through both models, then each Adam update at
    ``schedule(step)`` (an encoder group at ``lr / decoder_lr_times``).
    Returns the metrics: ``loss``, the detached ``terms``, and the mIoU and
    IoUs of ``pred_sup_1``, all device tensors."""
    state.opt_1.zero_grad(set_to_none=True)
    state.opt_2.zero_grad(set_to_none=True)
    loss.backward()
    lr = state.schedule(state.step)
    for opt in (state.opt_1, state.opt_2):
        set_lr(opt, lr)
        opt.step()
    state.step += 1
    with torch.no_grad():
        step_miou, iou_list = miou(confusion_matrix(pred_sup_1, l_target, num_classes))
    return dict(loss=loss.detach(), **{k: v.detach() for k, v in terms.items()},
                miou=step_miou, iou_list=iou_list)


def make_rept_cps_train_step(criterion, *, num_classes: int, cps_loss_weight: float = 1.0,
                             commitment_loss_weight: float = 1.0,
                             prototype_loss_weight: float = 0.01):
    """Build ``train_step(state, l_img, l_target, ul_img, drop_percent) ->
    (state, metrics)``.  Images are (N, 3, H, W) floats, labels (N, H, W)
    integers, ``drop_percent`` a float; ``state`` (a ``CPSTrainState``) is
    updated in place.  ``metrics`` holds device tensors: loss, cps_loss,
    sup_loss_1, sup_loss_2, commitment_loss, prototype_loss, code_usage,
    miou and iou_list."""

    @full_f32()
    def train_step(state: CPSTrainState, l_img, l_target, ul_img, drop_percent):
        m1, m2 = state.model_1, state.model_2
        modes = (m1.training, m2.training)
        try:
            m1.eval()
            m2.eval()
            with torch.no_grad():
                pl_1 = torch.argmax(m1(ul_img)[0], dim=1)
                pl_2 = torch.argmax(m2(ul_img)[0], dim=1)
            m1.train()
            m2.train()
            pred_sup_1, c_l1, u_l1, pt_l1 = m1(l_img, l_target, drop_percent, train=True)
            pred_sup_2, c_l2, u_l2, pt_l2 = m2(l_img, l_target, drop_percent, train=True)
            pred_ul_1, c_ul1, u_ul1, pt_ul1 = m1(ul_img, pl_2, drop_percent, train=True)
            pred_ul_2, c_ul2, u_ul2, pt_ul2 = m2(ul_img, pl_1, drop_percent, train=True)
        finally:
            m1.train(modes[0])
            m2.train(modes[1])

        pred_1 = torch.cat([pred_sup_1, pred_ul_1])
        pred_2 = torch.cat([pred_sup_2, pred_ul_2])
        pseudo_1 = regularized_pseudo(pred_1, drop_percent)
        pseudo_2 = regularized_pseudo(pred_2, drop_percent)
        cps_loss = criterion(pred_1, pseudo_2) + criterion(pred_2, pseudo_1)
        sup_loss_1 = criterion(pred_sup_1, l_target)
        sup_loss_2 = criterion(pred_sup_2, l_target)
        commitment = (c_l1 + c_l2 + c_ul1 + c_ul2) * commitment_loss_weight
        prototype = (pt_l1 + pt_l2 + pt_ul1 + pt_ul2) * prototype_loss_weight
        loss = sup_loss_1 + sup_loss_2 + cps_loss_weight * cps_loss + commitment + prototype

        return state, _update(state, loss, pred_sup_1, l_target, num_classes,
                              cps_loss=cps_loss, sup_loss_1=sup_loss_1, sup_loss_2=sup_loss_2,
                              commitment_loss=commitment, prototype_loss=prototype,
                              code_usage=(u_l1 + u_l2 + u_ul1 + u_ul2) / 4.0)

    return train_step


def _gt_passes(state: CPSTrainState, l_img, l_target, pseudo_img, ul_img, mix=None,
               sup_args=(), unsup_args=(), argmax: bool = True):
    """The ``(x, gt)`` networks' passes: each model's eval-mode prediction
    over ``pseudo_img`` under ``torch.no_grad`` (its argmax, or the score
    map itself without ``argmax``; mapped by ``mix`` where given), then
    four train-mode passes sup 1, sup 2, unsup 1 on ``ul_img`` with model
    2's labels, unsup 2 with model 1's, each followed by ``sup_args`` or
    ``unsup_args``; the models are left in the mode they were found in.
    Returns the two pseudo-label maps and the four outputs."""
    m1, m2 = state.model_1, state.model_2
    modes = (m1.training, m2.training)
    try:
        m1.eval()
        m2.eval()
        with torch.no_grad():
            pl_1, pl_2 = m1(pseudo_img)[0], m2(pseudo_img)[0]
            if argmax:
                pl_1, pl_2 = torch.argmax(pl_1, dim=1), torch.argmax(pl_2, dim=1)
            if mix is not None:
                pl_1, pl_2 = mix(pl_1), mix(pl_2)
        m1.train()
        m2.train()
        outs = (m1(l_img, l_target, *sup_args, train=True),
                m2(l_img, l_target, *sup_args, train=True),
                m1(ul_img, pl_2, *unsup_args, train=True),
                m2(ul_img, pl_1, *unsup_args, train=True))
    finally:
        m1.train(modes[0])
        m2.train(modes[1])
    return (pl_1, pl_2), outs


def _vq_terms(outs, commitment_loss_weight: float, prototype_loss_weight: float):
    """The four passes' weighted commitment and prototype sums and their
    mean code usage."""
    commitment = sum(o[1] for o in outs) * commitment_loss_weight
    prototype = sum(o[3] for o in outs) * prototype_loss_weight
    return commitment, prototype, sum(o[2] for o in outs) / 4.0


def make_vqpt_cps_train_step(criterion, *, num_classes: int, cps_loss_weight: float = 1.0,
                             commitment_loss_weight: float = 1.0,
                             prototype_loss_weight: float = 0.01):
    """Build ``train_step(state, l_img, l_target, ul_img) -> (state,
    metrics)``: CPS for the ``(x, gt)`` networks (reference
    deprecated/train_vq_pt_unet.py).

    cps = criterion(pred_1, argmax pred_2) + criterion(pred_2, argmax
    pred_1), each model's labeled and unlabeled predictions together, no
    confidence filter; sup = the criterion of each model's labeled pass; the
    four passes' commitment and prototype losses weighted.  ``metrics``
    holds device tensors: loss, cps_loss, sup_loss_1, sup_loss_2,
    commitment_loss, prototype_loss, code_usage, miou (of ``pred_sup_1``)
    and iou_list."""

    @full_f32()
    def train_step(state: CPSTrainState, l_img, l_target, ul_img):
        _, outs = _gt_passes(state, l_img, l_target, ul_img, ul_img)
        pred_sup_1, pred_sup_2, pred_ul_1, pred_ul_2 = (o[0] for o in outs)
        pred_1 = torch.cat([pred_sup_1, pred_ul_1])
        pred_2 = torch.cat([pred_sup_2, pred_ul_2])
        with torch.no_grad():
            pseudo_1, pseudo_2 = torch.argmax(pred_1, dim=1), torch.argmax(pred_2, dim=1)
        cps_loss = criterion(pred_1, pseudo_2) + criterion(pred_2, pseudo_1)
        sup_loss_1 = criterion(pred_sup_1, l_target)
        sup_loss_2 = criterion(pred_sup_2, l_target)
        commitment, prototype, usage = _vq_terms(outs, commitment_loss_weight,
                                                 prototype_loss_weight)
        loss = sup_loss_1 + sup_loss_2 + cps_loss_weight * cps_loss + commitment + prototype
        return state, _update(state, loss, pred_sup_1, l_target, num_classes,
                              cps_loss=cps_loss, sup_loss_1=sup_loss_1, sup_loss_2=sup_loss_2,
                              commitment_loss=commitment, prototype_loss=prototype,
                              code_usage=usage)

    return train_step


def dihedral(x: torch.Tensor, case: int) -> torch.Tensor:
    """The easy view's transform, its own inverse: case 1 flips the width,
    2 the height, any other case is the identity.  NCHW images and (N, H,
    W) labels alike (width the last axis, height the one before)."""
    if case == 1:
        return torch.flip(x, dims=(-1,))
    if case == 2:
        return torch.flip(x, dims=(-2,))
    return x


def make_easyhard_cps_train_step(criterion, *, num_classes: int, cps_loss_weight: float = 1.0,
                                 commitment_loss_weight: float = 1.0,
                                 prototype_loss_weight: float = 0.01):
    """Build ``train_step(state, l_img, l_target, ul_img, mask, case) ->
    (state, metrics)``: easy-hard CPS (reference
    deprecated/train_vqpt_easyhard_aug.py).

    ``mask`` is the (H, W) CutMix mask (``data/augmentations.py``), ``case``
    the dihedral case (``dihedral``).  The pseudo-labels come from the
    easy view ``dihedral(ul_img, case)``, mapped back and CutMix'd with the
    mask: ``pl * m + roll(pl, -1, 0) * (1 - m)``; the unlabeled passes
    train on the hard view, the images mixed with the same mask.  cps =
    (criterion of each labeled pass against the other's argmax + criterion
    of each hard pass against the other's mixed pseudo-labels) x
    ``cps_loss_weight``; sup = both labeled passes' criterion.  ``metrics``
    holds device tensors: loss, cps_loss, sup_loss, commitment_loss,
    prototype_loss, code_usage, miou (of ``pred_sup_1``) and iou_list."""

    @full_f32()
    def train_step(state: CPSTrainState, l_img, l_target, ul_img, mask, case: int):
        (pl_1, pl_2), outs = _gt_passes(state, l_img, l_target, dihedral(ul_img, case),
                                        cutmix(ul_img, mask),
                                        lambda pl: cutmix(dihedral(pl, case), mask))
        pred_sup_1, pred_sup_2, pred_ul_1, pred_ul_2 = (o[0] for o in outs)
        with torch.no_grad():
            sp_1, sp_2 = torch.argmax(pred_sup_1, dim=1), torch.argmax(pred_sup_2, dim=1)
        sup_cps = criterion(pred_sup_1, sp_2) + criterion(pred_sup_2, sp_1)
        unsup_cps = criterion(pred_ul_1, pl_2) + criterion(pred_ul_2, pl_1)
        cps_loss = (sup_cps + unsup_cps) * cps_loss_weight
        sup_loss = criterion(pred_sup_1, l_target) + criterion(pred_sup_2, l_target)
        commitment, prototype, usage = _vq_terms(outs, commitment_loss_weight,
                                                 prototype_loss_weight)
        loss = sup_loss + cps_loss + commitment + prototype
        return state, _update(state, loss, pred_sup_1, l_target, num_classes,
                              cps_loss=cps_loss, sup_loss=sup_loss, commitment_loss=commitment,
                              prototype_loss=prototype, code_usage=usage)

    return train_step


def _plain_passes(state: CPSTrainState, l_img, ul_img, split):
    """The four train-mode passes sup 1, sup 2, unsup 1, unsup 2 of a
    plain-forward network, the models left in the mode they were found in.
    ``split`` takes a network output to (prediction, extra).  Returns the
    labeled predictions, each model's labeled and unlabeled predictions
    together, their argmax labels and the four extras."""
    m1, m2 = state.model_1, state.model_2
    modes = (m1.training, m2.training)
    try:
        m1.train()
        m2.train()
        outs = (m1(l_img, train=True), m2(l_img, train=True),
                m1(ul_img, train=True), m2(ul_img, train=True))
    finally:
        m1.train(modes[0])
        m2.train(modes[1])
    (p_l1, e_l1), (p_l2, e_l2), (p_ul1, e_ul1), (p_ul2, e_ul2) = map(split, outs)
    pred_1 = torch.cat([p_l1, p_ul1])
    pred_2 = torch.cat([p_l2, p_ul2])
    with torch.no_grad():
        pseudo = (torch.argmax(pred_1, dim=1), torch.argmax(pred_2, dim=1))
    return (p_l1, p_l2), (pred_1, pred_2), pseudo, (e_l1, e_l2, e_ul1, e_ul2)


def make_plain_cps_train_step(*, num_classes: int, cps_loss_weight: float = 1.0, ce_weight=None,
                              usage_loss_weight: float = 0.0, depth: int = 5):
    """Build ``train_step(state, l_img, l_target, ul_img) -> (state,
    metrics)``: plain CPS (reference deprecated/train_CPS.py).

    cps = CE(p1, argmax p2) + CE(p2, argmax p1) over the labeled and
    unlabeled passes together; sup = CE of each model's labeled pass.  The
    criterion is always CE with ignore index 255 and ``ce_weight``: the
    config's criterion name is not read (``cps_vqv2_kmeans_init.json``
    says dice_loss and trains on CE), as in the JAX package.  There are no
    VQ terms.  ``usage_loss_weight`` adds sum(usage) / depth of each pass,
    where the usage is ``out[2]`` of a tuple output; it comes from counts,
    so it carries no gradient.  ``metrics`` holds device tensors: loss,
    cps_loss, sup_loss_1, sup_loss_2, usage_loss, miou (of ``pred_sup_1``)
    and iou_list."""

    def ce(pred, target):
        return cross_entropy_loss(pred, target, ignore_index=IGNORE, weight=ce_weight)

    def split(out):
        if isinstance(out, tuple):
            return out[0], (out[2] if len(out) > 2 else out[0].new_zeros((0,)))
        return out, out.new_zeros((0,))

    @full_f32()
    def train_step(state: CPSTrainState, l_img, l_target, ul_img):
        (pred_sup_1, pred_sup_2), (pred_1, pred_2), (pseudo_1, pseudo_2), usages = \
            _plain_passes(state, l_img, ul_img, split)
        cps_loss = ce(pred_1, pseudo_2) + ce(pred_2, pseudo_1)
        sup_loss_1 = ce(pred_sup_1, l_target)
        sup_loss_2 = ce(pred_sup_2, l_target)
        loss = sup_loss_1 + sup_loss_2 + cps_loss_weight * cps_loss
        usage_loss = l_img.new_zeros((), dtype=torch.float32)
        if usage_loss_weight:
            usage_loss = sum(torch.sum(u) / depth for u in usages)
            loss = loss + usage_loss_weight * usage_loss
        return state, _update(state, loss, pred_sup_1, l_target, num_classes,
                              cps_loss=cps_loss, sup_loss_1=sup_loss_1,
                              sup_loss_2=sup_loss_2, usage_loss=usage_loss)

    return train_step


def make_objloss_cps_train_step(criterion, object_criterion, *, num_classes: int,
                                batch_size: int, cps_loss_weight: float = 1.0,
                                commitment_loss_weight: float = 1.0,
                                obj_loss_weight: float = 1.0):
    """Build ``train_step(state, l_img, l_target, ul_img) -> (state,
    metrics)``: plain CPS plus a binary object loss (reference
    deprecated/train_with_test_object_loss.py).

    cps and sup as the plain step but with ``criterion``; the object
    prediction is the softmax mass of the non-background classes and
    ``object_criterion`` (the configured loss at one class) applies its own
    sigmoid to it, as the JAX package does.  Model 1's object target is the
    labels on the labeled half and model 2's pseudo-labels of the
    *unlabeled* half (``pseudo_2[-batch_size:]``), and the other way round;
    the four passes' commitment losses are added, weighted.  ``metrics``
    holds device tensors: loss, cps_loss, sup_loss, obj_loss,
    commitment_loss, miou (of ``pred_sup_1``) and iou_list."""

    def split(out):
        if not isinstance(out, tuple):
            return out, out.new_zeros(())
        commit = out[1] if len(out) > 1 else None
        return out[0], out[0].new_zeros(()) if commit is None else commit

    def to_obj_pred(pred):
        return torch.sum(torch.softmax(pred, dim=1)[:, 1:], dim=1, keepdim=True)

    @full_f32()
    def train_step(state: CPSTrainState, l_img, l_target, ul_img):
        (pred_sup_1, pred_sup_2), (pred_1, pred_2), (pseudo_1, pseudo_2), commits = \
            _plain_passes(state, l_img, ul_img, split)
        with torch.no_grad():
            obj_t1 = (torch.cat([l_target, pseudo_1[-batch_size:]]) != 0).long()
            obj_t2 = (torch.cat([l_target, pseudo_2[-batch_size:]]) != 0).long()
        cps_loss = criterion(pred_1, pseudo_2) + criterion(pred_2, pseudo_1)
        sup_loss = criterion(pred_sup_1, l_target) + criterion(pred_sup_2, l_target)
        obj_loss = (object_criterion(to_obj_pred(pred_1), obj_t2)
                    + object_criterion(to_obj_pred(pred_2), obj_t1))
        commitment = sum(commits)
        loss = (sup_loss + cps_loss_weight * cps_loss + commitment_loss_weight * commitment
                + obj_loss_weight * obj_loss)
        return state, _update(state, loss, pred_sup_1, l_target, num_classes,
                              cps_loss=cps_loss, sup_loss=sup_loss, obj_loss=obj_loss,
                              commitment_loss=commitment)

    return train_step


def make_angularv3_cps_train_step(dice_loss, *, num_classes: int, cps_loss_weight: float = 1.0,
                                  commitment_loss_weight: float = 1.0,
                                  prototype_loss_weight: float = 0.01, ce_weight=None):
    """Build ``train_step(state, l_img, l_target, ul_img, th) -> (state,
    metrics)``: angular-v3 CPS (reference deprecated/train_angularv3.py)
    for ``vqreptunetangularv3``.

    The eval pseudo passes give each model's score map; the labeled passes
    take the labels on the ``"labeled"`` split at threshold 0, the
    unlabeled passes the other model's score map on ``"unlabeled"`` at
    ``th``.  The CPS target of each model's predictions is the other's
    argmax where the other's largest score exceeds ``th`` (the raw score,
    no softmax), else 255.  cps = 0.5 CE + dice of each pair; sup = 0.5 CE
    + dice of each labeled pass; the four passes' commitment and angular
    losses weighted.  ``metrics`` holds device tensors: loss, cps_loss,
    sup_loss_1, sup_loss_2, commitment_loss, prototype_loss, code_usage,
    miou (of ``pred_sup_1``) and iou_list."""

    def ce(pred, target):
        return cross_entropy_loss(pred, target, ignore_index=IGNORE, weight=ce_weight)

    def filtered(pred, th):
        label = torch.argmax(pred, dim=1)
        return torch.where(torch.amax(pred, dim=1) > th, label, torch.full_like(label, IGNORE))

    @full_f32()
    def train_step(state: CPSTrainState, l_img, l_target, ul_img, th):
        _, outs = _gt_passes(state, l_img, l_target, ul_img, ul_img, sup_args=("labeled", 0.0),
                             unsup_args=("unlabeled", th), argmax=False)
        pred_sup_1, pred_sup_2, pred_ul_1, pred_ul_2 = (o[0] for o in outs)
        pred_1 = torch.cat([pred_sup_1, pred_ul_1])
        pred_2 = torch.cat([pred_sup_2, pred_ul_2])
        with torch.no_grad():
            filt_1, filt_2 = filtered(pred_1, th), filtered(pred_2, th)
        cps_loss = (0.5 * ce(pred_1, filt_2) + 0.5 * ce(pred_2, filt_1)
                    + dice_loss(pred_1, filt_2) + dice_loss(pred_2, filt_1))
        sup_loss_1 = 0.5 * ce(pred_sup_1, l_target) + dice_loss(pred_sup_1, l_target)
        sup_loss_2 = 0.5 * ce(pred_sup_2, l_target) + dice_loss(pred_sup_2, l_target)
        commitment, prototype, usage = _vq_terms(outs, commitment_loss_weight,
                                                 prototype_loss_weight)
        loss = sup_loss_1 + sup_loss_2 + cps_loss_weight * cps_loss + commitment + prototype
        return state, _update(state, loss, pred_sup_1, l_target, num_classes,
                              cps_loss=cps_loss, sup_loss_1=sup_loss_1, sup_loss_2=sup_loss_2,
                              commitment_loss=commitment, prototype_loss=prototype,
                              code_usage=usage)

    return train_step


def make_supcon_cps_train_step(criterion, *, num_classes: int, cps_loss_weight: float = 1.0,
                               commitment_loss_weight: float = 1.0,
                               sup_con_loss_weight: float = 1.0):
    """Build ``train_step(state, l_img, l_target, ul_img) -> (state,
    metrics)``: SupCon CPS (reference deprecated/train_supcon_unet.py) for
    ``supconvqunet``.

    As the ``vqpt`` step, with the labeled passes on the ``"label"`` split,
    which adds each model's supervised-contrastive loss, weighted by
    ``sup_con_loss_weight``; sup = the criterion of both labeled passes.
    ``metrics`` holds device tensors: loss, cps_loss, sup_loss,
    sup_con_loss, commitment_loss, code_usage, miou (of ``pred_sup_1``) and
    iou_list."""

    @full_f32()
    def train_step(state: CPSTrainState, l_img, l_target, ul_img):
        _, outs = _gt_passes(state, l_img, l_target, ul_img, ul_img, sup_args=("label",),
                             unsup_args=(None,))
        pred_sup_1, pred_sup_2, pred_ul_1, pred_ul_2 = (o[0] for o in outs)
        pred_1 = torch.cat([pred_sup_1, pred_ul_1])
        pred_2 = torch.cat([pred_sup_2, pred_ul_2])
        with torch.no_grad():
            pseudo_1, pseudo_2 = torch.argmax(pred_1, dim=1), torch.argmax(pred_2, dim=1)
        cps_loss = criterion(pred_1, pseudo_2) + criterion(pred_2, pseudo_1)
        sup_loss = criterion(pred_sup_1, l_target) + criterion(pred_sup_2, l_target)
        commitment = sum(o[1] for o in outs) * commitment_loss_weight
        sup_con = (outs[0][3] + outs[1][3]) * sup_con_loss_weight
        loss = sup_loss + cps_loss_weight * cps_loss + commitment + sup_con
        return state, _update(state, loss, pred_sup_1, l_target, num_classes,
                              cps_loss=cps_loss, sup_loss=sup_loss, sup_con_loss=sup_con,
                              commitment_loss=commitment,
                              code_usage=sum(o[2] for o in outs) / 4.0)

    return train_step


def overlapped_patches(ul_img: torch.Tensor, overlap_size: int = 240):
    """Two overlapping square crops of an (N, C, H, W) batch, ``overlap_size
    + overlap_size // 3`` wide, the first ``overlap_size // 3`` up and left
    of the second, which sits ``overlap_size // 2`` up and left of the
    centre."""
    h, w = ul_img.shape[-2:]
    add = overlap_size // 3
    patch = overlap_size + add
    hc, wc = h // 2, w // 2
    y1, x1 = hc - overlap_size // 2 - add, wc - overlap_size // 2 - add
    y2, x2 = hc - overlap_size // 2, wc - overlap_size // 2
    return (ul_img[..., y1:y1 + patch, x1:x1 + patch],
            ul_img[..., y2:y2 + patch, x2:x2 + patch])


def make_semiweed_train_step(criterion, *, num_classes: int, overlap_size: int = 240,
                             ce_loss_weight: float = 1.0, dc_loss_weight: float = 1.0):
    """Build ``train_step(state, l_img, l_target, ul_img, case1, case2,
    dropout=(None, None, None)) -> (state, metrics)``: SemiWeedNet's
    contrastive semi-supervision (reference
    deprecated/semiweednet_train.py) for one model (a supervised
    ``TrainState``).

    Three train-mode passes, the BN statistics threaded through them: the
    labeled batch (``issup``), then each of the two ``overlapped_patches``
    of the unlabeled batch after its ``dihedral`` flip (``case1``,
    ``case2``), whose MLP projections enter the diagonal-cosine loss.
    ``dropout`` gives each pass's ASPP dropout (a callable ``shape ->
    mask``, ``models/networks/deeplabv3.py``).  loss =
    ``ce_loss_weight`` x criterion(labeled pass) + ``dc_loss_weight`` x
    dc.  ``metrics`` holds device tensors: loss, ce_loss, dc_loss, miou and
    iou_list."""

    @full_f32()
    def train_step(state: TrainState, l_img, l_target, ul_img, case1: int, case2: int,
                   dropout=(None, None, None)):
        model = state.model
        p1, p2 = overlapped_patches(ul_img, overlap_size)
        p1, p2 = dihedral(p1, case1), dihedral(p2, case2)
        was_training = model.training
        model.train()
        try:
            pred_sup, _ = model(l_img, issup=True, train=True, dropout=dropout[0])
            _, mlp1 = model(p1, train=True, dropout=dropout[1])
            _, mlp2 = model(p2, train=True, dropout=dropout[2])
        finally:
            model.train(was_training)
        ce = criterion(pred_sup, l_target)
        dc = dc_loss(mlp1, mlp2)
        loss = ce_loss_weight * ce + dc_loss_weight * dc
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        set_lr(state.opt, state.schedule(state.step))
        state.opt.step()
        state.step += 1
        with torch.no_grad():
            step_miou, iou_list = miou(confusion_matrix(pred_sup, l_target, num_classes))
        return state, dict(loss=loss.detach(), ce_loss=ce.detach(), dc_loss=dc.detach(),
                           miou=step_miou, iou_list=iou_list)

    return train_step


@torch.no_grad()
def confident_pseudo(pred: torch.Tensor, threshold: float) -> torch.Tensor:
    """(N, C, H, W) logits -> their argmax where the softmax maximum
    exceeds ``threshold``, else 255."""
    prob = torch.softmax(pred.float(), dim=1)
    pmax, label = torch.max(prob, dim=1)
    return torch.where(pmax > threshold, label, torch.full_like(label, IGNORE))


def make_unimatch_train_step(*, num_classes: int, confidence_threshold: float = 0.95,
                             ce_weight=None):
    """Build ``train_step(state, l_img, l_target, ul_img, mask_1, mask_2,
    dropout=None, fp_dropout=None) -> (state, metrics)``: UniMatch
    (reference deprecated/train_UniMatch.py) for one ``unimatch`` network
    (a supervised ``TrainState``).

    * The teacher: the model in eval mode over the unlabeled batch under
      ``torch.no_grad``.
    * Two CutMix views, each of the unlabeled batch and of the teacher's
      *logits* with one box (``mask_1``, ``mask_2``: (H, W), 0 in the box),
      mixing item i with item i + 1; their pseudo-labels are the mixed
      logits' argmax where the softmax maximum exceeds
      ``confidence_threshold``, else 255.
    * Four train-mode passes, the BN statistics threaded in this order: the
      labeled batch, the unlabeled batch with ``need_fp`` (whose perturbed
      output learns the teacher's own pseudo-labels), mix 1, mix 2.
    * loss = (sup + 0.25 u1 + 0.25 u2 + 0.5 fp) / 2, each CE with ignore
      index 255 and ``ce_weight``; one Adam update at ``schedule(step)``.

    The JAX step hands one dropout key to all four passes, so a dropout
    site draws the same mask wherever its shape repeats: ``dropout`` (the
    ASPP's, a callable ``shape -> keep``) must give one mask per shape
    (the labeled pass and the two mixes share it; the ``need_fp`` pass's
    2N rows get another), ``fp_dropout`` the perturbation's two masks, in
    order.  ``metrics`` holds device tensors: loss, sup_loss, loss_u_1,
    loss_u_2, loss_u_fp, miou (of the labeled pass) and iou_list."""

    def ce(pred, target):
        return cross_entropy_loss(pred, target, ignore_index=IGNORE, weight=ce_weight)

    @full_f32()
    def train_step(state: TrainState, l_img, l_target, ul_img, mask_1, mask_2, dropout=None,
                   fp_dropout=None):
        model = state.model
        was_training = model.training
        try:
            model.eval()
            with torch.no_grad():
                pred_u = model(ul_img)[0]
            mix_in_1, mix_pred_1 = cutmix(ul_img, mask_1), cutmix(pred_u, mask_1)
            mix_in_2, mix_pred_2 = cutmix(ul_img, mask_2), cutmix(pred_u, mask_2)
            model.train()
            pred_l, _ = model(l_img, train=True, dropout=dropout)
            _, pred_fp = model(ul_img, need_fp=True, train=True, dropout=dropout,
                               fp_dropout=fp_dropout)
            pred_mix_1, _ = model(mix_in_1, train=True, dropout=dropout)
            pred_mix_2, _ = model(mix_in_2, train=True, dropout=dropout)
        finally:
            model.train(was_training)
        sup = ce(pred_l, l_target)
        loss_u_1 = ce(pred_mix_1, confident_pseudo(mix_pred_1, confidence_threshold))
        loss_u_2 = ce(pred_mix_2, confident_pseudo(mix_pred_2, confidence_threshold))
        loss_u_fp = ce(pred_fp, confident_pseudo(pred_u, confidence_threshold))
        loss = (sup + 0.25 * loss_u_1 + 0.25 * loss_u_2 + 0.5 * loss_u_fp) / 2
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        set_lr(state.opt, state.schedule(state.step))
        state.opt.step()
        state.step += 1
        with torch.no_grad():
            step_miou, iou_list = miou(confusion_matrix(pred_l, l_target, num_classes))
        return state, dict(loss=loss.detach(), sup_loss=sup.detach(),
                           loss_u_1=loss_u_1.detach(), loss_u_2=loss_u_2.detach(),
                           loss_u_fp=loss_u_fp.detach(), miou=step_miou, iou_list=iou_list)

    return train_step


def salient_loss(sal_pred: torch.Tensor, sal_map: torch.Tensor) -> torch.Tensor:
    """MSE between an (N, 1, h, w) saliency prediction and an (N, H, W)
    map resized to (h, w) with half-pixel nearest indexing
    (``jax.image.resize(..., "nearest")``)."""
    target = resize_nearest_exact(sal_map, tuple(sal_pred.shape[-2:]))[:, None]
    return torch.mean((sal_pred.float() - target) ** 2)


def make_salient_cps_train_step(*, num_classes: int, cps_loss_weight: float = 1.0,
                                commitment_loss_weight: float = 1.0,
                                auxiliary_loss_weight: float = 1.0, ce_weight=None):
    """Build ``train_step(state, l_img, l_target, l_sal, ul_img, ul_sal) ->
    (state, metrics)``: salient-loss CPS (reference
    deprecated/train_salient_loss.py) for two ``VQUnetwithSalientloss``
    networks.

    Four train-mode passes (model 1 and 2 on the labeled batch, then on
    the unlabeled one); cps = CE(pred_1, argmax pred_2) + CE(pred_2, argmax
    pred_1) over each model's labeled and unlabeled predictions together;
    sup = the CE of both labeled passes; the four commitment losses; the
    four saliency MSEs (``salient_loss``) against ``l_sal``/``ul_sal``
    ((N, H, W) maps in [0, 1]).  loss = sup + ``cps_loss_weight`` cps +
    ``commitment_loss_weight`` commitment + ``auxiliary_loss_weight``
    salient; CE with ignore index 255 and ``ce_weight``.  ``metrics`` holds
    device tensors: loss, cps_loss, salient_loss, commitment_loss, miou (of
    ``pred_sup_1``) and iou_list."""

    def ce(pred, target):
        return cross_entropy_loss(pred, target, ignore_index=IGNORE, weight=ce_weight)

    @full_f32()
    def train_step(state: CPSTrainState, l_img, l_target, l_sal, ul_img, ul_sal):
        m1, m2 = state.model_1, state.model_2
        modes = (m1.training, m2.training)
        try:
            m1.train()
            m2.train()
            outs = (m1(l_img, train=True), m2(l_img, train=True),
                    m1(ul_img, train=True), m2(ul_img, train=True))
        finally:
            m1.train(modes[0])
            m2.train(modes[1])
        pred_sup_1, pred_sup_2, pred_ul_1, pred_ul_2 = (o[0] for o in outs)
        pred_1 = torch.cat([pred_sup_1, pred_ul_1])
        pred_2 = torch.cat([pred_sup_2, pred_ul_2])
        with torch.no_grad():
            pseudo_1, pseudo_2 = torch.argmax(pred_1, dim=1), torch.argmax(pred_2, dim=1)
        cps_loss = ce(pred_1, pseudo_2) + ce(pred_2, pseudo_1)
        sup = ce(pred_sup_1, l_target) + ce(pred_sup_2, l_target)
        commitment = sum(o[1] for o in outs)
        salient = sum(salient_loss(o[3], sal)
                      for o, sal in zip(outs, (l_sal, l_sal, ul_sal, ul_sal)))
        loss = (sup + cps_loss_weight * cps_loss + commitment_loss_weight * commitment
                + auxiliary_loss_weight * salient)
        return state, _update(state, loss, pred_sup_1, l_target, num_classes,
                              cps_loss=cps_loss, salient_loss=salient,
                              commitment_loss=commitment)

    return train_step
