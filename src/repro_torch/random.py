"""The port's random-number seam: functional keys, as ``jax.random`` has them.

The port calls :func:`split` and :func:`fold_in` exactly where the reference
calls ``jax.random.split`` and ``jax.random.fold_in``, and draws through
:func:`randint`, :func:`categorical`, :func:`uniform`, :func:`gumbel` and
:func:`choice` where the reference draws through their ``jax.random``
namesakes (:func:`choice` without replacement). Each function delegates to
its key, so any object with the methods of :class:`Key` can stand in for
the production :class:`TorchKey` (the tests use one that calls
``jax.random`` to follow the reference's draws).

:class:`TorchKey` is an integer; each draw seeds a fresh ``torch.Generator``
on the device of the tensors it makes, and :meth:`TorchKey.split` and
:meth:`TorchKey.fold_in` derive child integers with a SplitMix64 hash. The
same key gives the same draws on the same device; CPU and CUDA generators
give different numbers. :func:`key_to_words` and :func:`key_from_words`
carry a key through the reference's checkpoint format, which stores a key
as ``uint32[2]``: the seed's high word, then its low word.
"""

from __future__ import annotations

from typing import Protocol

import numpy as np
import torch

from repro_torch.scan import prefix_sum

__all__ = [
    "Key", "TorchKey", "categorical", "choice", "fold_in", "gumbel", "key", "key_from_words",
    "key_to_words", "randint", "split", "uniform",
]

_MASK64 = (1 << 64) - 1
#: the most categories ``torch.multinomial`` takes
_MULTINOMIAL_MAX = 1 << 24


class Key(Protocol):
    def split(self, num: int) -> tuple["Key", ...]: ...

    def fold_in(self, data: int) -> "Key": ...

    def randint(self, shape, minval: int, maxval: int, device) -> torch.Tensor: ...

    def categorical(self, logits: torch.Tensor, shape=None) -> torch.Tensor: ...

    def uniform(self, shape, device) -> torch.Tensor: ...

    def gumbel(self, shape, device) -> torch.Tensor: ...

    def choice(self, n: int, shape, device) -> torch.Tensor: ...


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


class TorchKey:
    """A functional key over ``torch.Generator``."""

    __slots__ = ("seed",)

    def __init__(self, seed: int):
        self.seed = int(seed) & _MASK64

    def __repr__(self) -> str:
        return f"TorchKey({self.seed:#x})"

    def _gen(self, device) -> torch.Generator:
        return torch.Generator(device=torch.device(device)).manual_seed(self.seed >> 1)

    def split(self, num: int) -> tuple["TorchKey", ...]:
        return tuple(
            TorchKey(_splitmix64(self.seed ^ _splitmix64(i + 1))) for i in range(num)
        )

    def fold_in(self, data: int) -> "TorchKey":
        """The key for ``data`` under this one; distinct from every
        :meth:`split` child (those hash ``i + 1`` into the seed itself)."""
        return TorchKey(_splitmix64(_splitmix64(self.seed) ^ (int(data) & _MASK64)))

    def randint(self, shape, minval, maxval, device) -> torch.Tensor:
        return torch.randint(
            int(minval), int(maxval), tuple(shape), generator=self._gen(device),
            device=device,
        )

    def categorical(self, logits: torch.Tensor, shape=None) -> torch.Tensor:
        """Draws ∝ ``exp(logits)`` over the last axis of a 1-D ``logits`` of
        any length n; ``shape=(m,)`` draws m times from the same
        distribution in O(n + m) memory. One draw, and every draw on the
        CPU, over up to 2^24 categories is ``torch.multinomial``'s, whose
        input check reads a scalar back to the host. Past its limit, and
        for several draws on CUDA (where its prefix sum is not the same from
        run to run), it is an inverse-CDF draw: a float64
        :func:`~repro_torch.scan.prefix_sum`, then ``searchsorted`` of m
        uniforms."""
        num = 1 if shape is None else int(torch.Size(shape).numel())
        gen = self._gen(logits.device)
        n = logits.shape[-1]
        if n <= _MULTINOMIAL_MAX and (num == 1 or logits.device.type != "cuda"):
            probs = torch.softmax(logits.float(), dim=-1)
            out = torch.multinomial(probs, num, replacement=True, generator=gen)
        else:
            probs = torch.softmax(logits.double(), dim=-1)
            cdf = prefix_sum(probs)
            u = torch.rand(num, dtype=torch.float64, generator=gen, device=logits.device)
            out = torch.searchsorted(cdf, u * cdf[-1], right=True)
            # u·cdf[-1] can round up to cdf[-1]: stay on the last drawable category
            last = torch.where(probs > 0, torch.arange(n, device=logits.device), 0).max()
            out = torch.minimum(out, last)
        return out[0] if shape is None else out.reshape(tuple(shape))

    def uniform(self, shape, device) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self._gen(device), device=device)

    def gumbel(self, shape, device) -> torch.Tensor:
        tiny = torch.finfo(torch.float32).tiny
        u = self.uniform(shape, device).clamp(min=tiny, max=1.0 - 2.0**-24)
        return -torch.log(-torch.log(u))

    def choice(self, n, shape, device) -> torch.Tensor:
        """``prod(shape)`` distinct indices of ``range(n)``, uniformly."""
        k = int(torch.Size(shape).numel())
        if k > n:
            raise ValueError(f"cannot draw {k} distinct indices from {n}")
        perm = torch.randperm(int(n), generator=self._gen(device), device=device)
        return perm[:k].reshape(tuple(shape))


def key(seed: int) -> TorchKey:
    """The production key for ``seed``."""
    return TorchKey(seed)


def key_to_words(key: TorchKey) -> np.ndarray:
    """``key`` as ``uint32[2]``, the reference's stored form of a key."""
    return np.array([key.seed >> 32, key.seed & 0xFFFFFFFF], np.uint32)


def key_from_words(words) -> TorchKey:
    """The key of :func:`key_to_words`' two words, high word first."""
    hi, lo = (int(w) for w in np.asarray(words, np.uint32).reshape(2))
    return TorchKey((hi << 32) | lo)


def split(key: Key, num: int = 2) -> tuple[Key, ...]:
    return key.split(num)


def fold_in(key: Key, data: int) -> Key:
    return key.fold_in(data)


def randint(key: Key, shape, minval: int, maxval: int, *, device) -> torch.Tensor:
    return key.randint(shape, minval, maxval, device)


def categorical(key: Key, logits: torch.Tensor, shape=None) -> torch.Tensor:
    return key.categorical(logits, shape)


def uniform(key: Key, shape, *, device) -> torch.Tensor:
    return key.uniform(shape, device)


def gumbel(key: Key, shape, *, device) -> torch.Tensor:
    return key.gumbel(shape, device)


def choice(key: Key, n: int, shape, *, device) -> torch.Tensor:
    """Indices of ``range(n)`` without replacement, as
    ``jax.random.choice(key, n, shape, replace=False)`` draws them."""
    return key.choice(n, shape, device)
