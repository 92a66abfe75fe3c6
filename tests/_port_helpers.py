"""Shared helpers of the parity tests of the ``angularv3``, ``supconcps``,
``semiweed`` and ``selfsup`` slice: layout conversions, the relative L2
distance, JAX's f64 context and a recorder of the dropout masks flax
draws.

``record_dropout()`` binds, for the duration of a ``with`` block, a
subclass of ``flax.linen.Dropout`` named ``Dropout`` (so its auto-name and
its random stream are flax's own) that draws the mask exactly as flax does
and hands it to the host with an ordered ``jax.debug.callback``: the JAX
package is not edited, and a jitted program traced inside the block keeps
recording whenever it runs later.  ``replay_dropout(masks)`` makes the
same subclass use given masks instead."""
import contextlib
from unittest import mock

import flax
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax import lax


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def to_np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@contextlib.contextmanager
def jax_f64():
    """Every f32 of the JAX package widened to f64 inside the block."""
    with jax.enable_x64(True), mock.patch.object(jnp, "float32", jnp.float64):
        yield


@contextlib.contextmanager
def port_f64():
    """``Tensor.float()`` leaves f64 tensors as they are inside the block, so
    that a port module cast to f64 stays f64 where it pins f32."""
    f32 = torch.Tensor.float
    with mock.patch.object(torch.Tensor, "float",
                           lambda t: t if t.dtype == torch.float64 else f32(t)):
        yield


def wide(tree):
    """float32 leaves of a numpy tree as float64."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype == np.float32 else a, tree)


MASKS = []  # the masks recorded, NHWC bool, in the order flax drew them
REPLAY = []  # masks to use in place of drawing, in order (``replay_dropout``)


class Dropout(nn.Dropout):
    @nn.compact
    def __call__(self, inputs, deterministic=None, rng=None):
        deterministic = nn.merge_param("deterministic", self.deterministic, deterministic)
        if self.rate == 0.0 or deterministic:
            return inputs
        keep_prob = 1.0 - self.rate
        if REPLAY:  # fixed at trace time
            mask = jnp.asarray(REPLAY.pop(0))
        else:
            if rng is None:
                rng = self.make_rng(self.rng_collection)
            mask = jax.random.bernoulli(rng, p=keep_prob, shape=inputs.shape)
            jax.debug.callback(lambda m: MASKS.append(np.asarray(m)), mask, ordered=True)
        return lax.select(mask, inputs / keep_prob, jnp.zeros_like(inputs))


@contextlib.contextmanager
def record_dropout():
    with mock.patch.object(flax.linen, "Dropout", Dropout):
        yield MASKS


@contextlib.contextmanager
def replay_dropout(masks):
    """Flax's dropout takes ``masks`` (NHWC bool), in order, in place of its
    draws: JAX's f64 run draws other masks than its f32 run."""
    REPLAY[:] = [np.asarray(m) for m in masks]
    try:
        with mock.patch.object(flax.linen, "Dropout", Dropout):
            yield
    finally:
        REPLAY.clear()


def take_masks(n: int):
    """The first ``n`` recorded masks as NCHW bool tensors, removed from
    the record."""
    out = [nchw(m) for m in MASKS[:n]]
    del MASKS[:n]
    return out
