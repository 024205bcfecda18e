"""Seed streams of the port (its own copy of ``pvraft_tpu/rng.py``'s
host side).

Every numpy generator is ``host_rng(seed, stream, *indices)``: the stream
name folds in as a stable crc32 tag, so two streams never collide from
the same seed. The tags and the ``SeedSequence`` entropy are those of the
JAX package, so the port's synthetic scenes, subsamples and epoch orders
are bitwise-identical to the JAX package's for the same seed.
"""

from __future__ import annotations

import zlib
from typing import Tuple, Union

import numpy as np

# The seed where no config seed exists (the serve probe payload), as in
# the JAX package.
DEFAULT_SEED = 0

# The streams the port uses, with what each seeds (names and meanings of
# pvraft_tpu/rng.py::STREAMS).
STREAMS: Tuple[Tuple[str, str], ...] = (
    ("model.init", "network parameter initialization"),
    ("data.shuffle", "epoch-level sample order"),
    ("data.subsample", "per-scene subsample permutations"),
    ("data.synthetic", "synthetic scene-flow scene generation"),
    ("serve.probe", "supervisor health-probe payload cloud"),
    ("serve.loadgen", "load-generator request payloads"),
    ("serve.retry_jitter", "load-generator retry backoff jitter"),
    ("profile.data", "step-profiler synthetic input clouds"),
    ("replay.input", "the program catalog's inputs (programs/catalog.py), "
                     "which the bitwise replay rebuilds"),
)

STREAM_NAMES: Tuple[str, ...] = tuple(name for name, _ in STREAMS)


def stream_tag(name: str) -> int:
    """Stable 31-bit tag of a declared stream name (crc32, masked
    positive)."""
    if name not in STREAM_NAMES:
        raise ValueError(f"undeclared rng stream {name!r}; known: "
                         f"{', '.join(STREAM_NAMES)}")
    return zlib.crc32(name.encode("utf-8")) & 0x7FFFFFFF


def host_entropy(seed: int, *parts: Union[str, int]) -> Tuple[int, ...]:
    """The entropy tuple of ``(seed, stream, *indices)``: the seed, then
    each stream name as its tag and each index as itself."""
    if not parts or not isinstance(parts[0], str):
        raise ValueError("host_rng needs a declared stream name as the "
                         "first part: host_rng(seed, 'data.synthetic', ...)")
    out = [int(seed)]
    for p in parts:
        if isinstance(p, str):
            out.append(stream_tag(p))
        elif isinstance(p, int) and not isinstance(p, bool):
            out.append(int(p))
        else:
            raise TypeError(f"rng parts must be stream names or ints, got "
                            f"{type(p).__name__}: {p!r}")
    return tuple(out)


def host_rng(seed: int, *parts: Union[str, int]) -> np.random.Generator:
    """A numpy ``Generator`` for ``(seed, stream, *indices)``."""
    return np.random.default_rng(host_entropy(seed, *parts))


def torch_seed(seed: int, *parts: Union[str, int]) -> int:
    """A 64-bit seed for a ``torch.Generator`` of the same stream (the
    port's weight initialisation draws its numbers from torch, not
    flax's)."""
    return int(np.random.SeedSequence(host_entropy(seed, *parts))
               .generate_state(1, np.uint64)[0])
