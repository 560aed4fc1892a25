"""The global RNG state: ``seed``, ``get_rng_state``/``set_rng_state``
and the named states of ``get_rng_state_tracker``.

Port of ``paddle_tpu/framework/random.py``. A :class:`Generator` is a
seed and, made at first use on each device, one ``torch.Generator`` per
device seeded with it (a draw on a CUDA tensor needs a CUDA generator).
Dropout given no generator draws from the default one
(``nn.functional.dropout``), and ``get_rng_state_tracker().rng_state(
name)`` swaps another in for its scope, as the JAX context does.

The seeds are the JAX package's: ``seed(n)`` reseeds the default
generator and every named state with ``n + 1000 + i`` (i in the order of
the sorted names), and a name first seen by ``rng_state`` seeds from
``zlib.crc32`` of the name, which every process computes alike (so ranks
agree). The streams drawn from a seed are ``torch.Generator``'s, not
``jax.random``'s.
"""

from __future__ import annotations

import contextlib
import zlib

import torch

__all__ = ["seed", "Generator", "default_generator", "get_rng_state",
           "set_rng_state", "RNGStatesTracker", "get_rng_state_tracker"]


def _device_key(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Generator:
    """A named seed with one ``torch.Generator`` per device."""

    def __init__(self, seed_: int = 0, name: str = "default"):
        self.name = name
        self._seed = int(seed_)
        self._gens: dict[torch.device, torch.Generator] = {}

    def initial_seed(self) -> int:
        return self._seed

    def manual_seed(self, seed_: int) -> "Generator":
        """Reseed: every device's generator restarts from ``seed_``."""
        self._seed = int(seed_)
        for gen in self._gens.values():
            gen.manual_seed(self._seed)
        return self

    def generator(self, device="cpu") -> torch.Generator:
        """The ``torch.Generator`` of ``device``, made from the seed at
        first use."""
        dev = _device_key(device)
        gen = self._gens.get(dev)
        if gen is None:
            gen = torch.Generator(device=dev).manual_seed(self._seed)
            self._gens[dev] = gen
        return gen

    def get_state(self) -> dict:
        """``{"seed": s, "states": {device: ByteTensor}}``: a copy."""
        return {"seed": self._seed,
                "states": {str(d): g.get_state()
                           for d, g in self._gens.items()}}

    def set_state(self, state: dict) -> None:
        """Restore :meth:`get_state`'s copy; a device the copy does not
        hold restarts from its seed."""
        self._seed = int(state["seed"])
        held = {_device_key(d): s for d, s in state["states"].items()}
        for dev in set(self._gens) | set(held):
            gen = self.generator(dev)
            if dev in held:
                gen.set_state(held[dev])
            else:
                gen.manual_seed(self._seed)


default_generator = Generator(0, "default")


def seed(value: int) -> Generator:
    """``paddle.seed``: reseed the default generator on every device (the
    port's and torch's own), and the tracker's named states."""
    default_generator.manual_seed(value)
    torch.manual_seed(int(value))
    _tracker.reseed_all(value)
    return default_generator


def get_rng_state():
    return [default_generator.get_state()]


def set_rng_state(states) -> None:
    if isinstance(states, (list, tuple)):
        states = states[0]
    default_generator.set_state(states)


class RNGStatesTracker:
    """Named RNG states for parallelism (fleet's
    ``get_rng_state_tracker``): dropout inside a tensor-parallel region
    differs per model rank (``local_seed``) but matches across ranks
    (``global_seed``)."""

    def __init__(self):
        self.states: dict[str, Generator] = {}

    def add(self, name: str, seed_: int) -> None:
        if name in self.states:
            raise ValueError(f"RNG state {name!r} already exists")
        self.states[name] = Generator(seed_, name)

    def reseed_all(self, base_seed: int) -> None:
        for i, (name, gen) in enumerate(sorted(self.states.items())):
            gen.manual_seed(base_seed + 1000 + i)

    def rng_state(self, name: str = "global_seed"):
        """Context: ``name``'s generator is the default one inside (made
        from ``crc32(name)`` at first use)."""
        @contextlib.contextmanager
        def ctx():
            global default_generator
            gen = self.states.get(name)
            if gen is None:
                gen = Generator(zlib.crc32(name.encode()) % (2 ** 31), name)
                self.states[name] = gen
            prev = default_generator
            default_generator = gen
            try:
                yield
            finally:
                default_generator = prev
        return ctx()


_tracker = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _tracker
