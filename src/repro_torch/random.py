"""The port's random-number seam: functional keys, as ``jax.random`` has them.

The port calls :func:`split` and :func:`fold_in` exactly where the reference
calls ``jax.random.split`` and ``jax.random.fold_in``, and draws through
:func:`randint`, :func:`categorical`, :func:`uniform` and :func:`gumbel`
where the reference draws through their ``jax.random`` namesakes. Each
function delegates to its key, so any object with the methods of
:class:`Key` can stand in for the production :class:`TorchKey` (the tests
use one that calls ``jax.random`` to follow the reference's draws).

:class:`TorchKey` is an integer; each draw seeds a fresh ``torch.Generator``
on the device of the tensors it makes, and :meth:`TorchKey.split` and
:meth:`TorchKey.fold_in` derive child integers with a SplitMix64 hash. The
same key gives the same draws on the same device; CPU and CUDA generators
give different numbers.
"""

from __future__ import annotations

from typing import Protocol

import torch

__all__ = [
    "Key", "TorchKey", "categorical", "fold_in", "gumbel", "key", "randint", "split", "uniform",
]

_MASK64 = (1 << 64) - 1


class Key(Protocol):
    def split(self, num: int) -> tuple["Key", ...]: ...

    def fold_in(self, data: int) -> "Key": ...

    def randint(self, shape, minval: int, maxval: int, device) -> torch.Tensor: ...

    def categorical(self, logits: torch.Tensor, shape=None) -> torch.Tensor: ...

    def uniform(self, shape, device) -> torch.Tensor: ...

    def gumbel(self, shape, device) -> torch.Tensor: ...


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
        """Draws ∝ ``exp(logits)`` over the last axis of a 1-D ``logits``;
        ``shape=(m,)`` draws m times from the same distribution in O(m)
        memory."""
        probs = torch.softmax(logits.float(), dim=-1)
        num = 1 if shape is None else int(torch.Size(shape).numel())
        out = torch.multinomial(probs, num, replacement=True, generator=self._gen(logits.device))
        return out[0] if shape is None else out.reshape(tuple(shape))

    def uniform(self, shape, device) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self._gen(device), device=device)

    def gumbel(self, shape, device) -> torch.Tensor:
        tiny = torch.finfo(torch.float32).tiny
        u = self.uniform(shape, device).clamp(min=tiny, max=1.0 - 2.0**-24)
        return -torch.log(-torch.log(u))


def key(seed: int) -> TorchKey:
    """The production key for ``seed``."""
    return TorchKey(seed)


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
