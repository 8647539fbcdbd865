"""Parallel enumeration of discrete latent sites — funsor-free.

Design (replaces the reference's funsor layer,
numpyro/contrib/funsor/enum_messenger.py:563-654, with direct array dims):
each enumerable sample site is substituted with its full support expanded
along a fresh *negative* array dim allocated to the LEFT of every plate dim
(``first_available_dim``).  Downstream log-probs then broadcast against these
enum dims, and the density engine (infer_util.log_density) eliminates them
with a logsumexp sum-product contraction.  On device the whole enumerated
density is one batched elementwise/reduction program — no host-side graph
machinery survives tracing.
"""

from __future__ import annotations



from numpyro_tpu.handlers import infer_config
from numpyro_tpu.primitives import Messenger

# marker key recording the allocated enum dim in a site's infer dict
ENUM_DIM_KEY = "_enum_dim"
# serial number distinguishing successive variables that recycle one dim
ENUM_SERIAL_KEY = "_enum_serial"
# total enum-dim budget (reference caps at 25, enum_messenger.py:84)
MAX_ENUM_DIMS = 25

# active markov frames: list of dicts {"period": int, "slot": int, "base": ...}
_MARKOV_STACK = []


class enum(Messenger):
    """Substitute each enumerable latent site with its expanded support.

    :param first_available_dim: most-positive dim available for enumeration,
        a negative integer left of all plate dims (e.g. ``-1 - max_plate_nesting``).
    """

    def __init__(self, fn=None, first_available_dim=None):
        assert first_available_dim is not None and first_available_dim < 0
        self.first_available_dim = first_available_dim
        super().__init__(fn)

    def __enter__(self):
        self._next_dim = self.first_available_dim
        self._serial = 0
        return super().__enter__()

    def process_message(self, msg):
        if msg["type"] == "control_flow" and "history" in msg["kwargs"]:
            # an effectful `scan` below us: hand it the enum protocol —
            # its wrapper enumerates carried discretes on recycled dims and
            # eliminates the whole time block with a parallel logmatmulexp
            # chain, emitting one factor back into this enumeration scope
            msg["kwargs"]["enum"] = True
            msg["kwargs"]["first_available_dim"] = self._next_dim
            msg["kwargs"]["enum_boundary"] = self.first_available_dim
            return
        if msg["type"] != "sample":
            return
        if msg["is_observed"] or msg["value"] is not None:
            return
        fn = msg["fn"]
        if not getattr(fn, "has_enumerate_support", False):
            return
        if msg["infer"].get("enumerate") != "parallel":
            return
        if ENUM_DIM_KEY in msg["infer"]:
            return

        if _MARKOV_STACK:
            # inside a markov context: dims are recycled from a small pool of
            # `history + 1` slots so chain length never grows the dim budget
            frame = _MARKOV_STACK[-1]
            if frame.get("base") is None:
                frame["base"] = self._next_dim
                self._next_dim -= frame["period"]
            dim = frame["base"] - (frame["slot"] % frame["period"])
        else:
            dim = self._next_dim
            self._next_dim -= 1
        if self.first_available_dim - dim >= MAX_ENUM_DIMS:
            raise RuntimeError(
                f"Exceeded the enumeration dim budget of {MAX_ENUM_DIMS}."
            )
        support = fn.enumerate_support(expand=False)
        # place the support axis K exactly at batch dim `dim` (counting from
        # the right edge of the batch region); broadcasting against wider
        # fn.batch_shape happens naturally in log_prob
        size = support.shape[0]
        shape = (size,) + (1,) * (-dim - 1)
        value = support.reshape(shape + fn.event_shape)
        msg["value"] = value
        msg["infer"][ENUM_DIM_KEY] = dim
        msg["infer"][ENUM_SERIAL_KEY] = self._serial
        self._serial += 1
        msg["infer"]["_enum_size"] = size
        # the site is enumerated, not sampled: no rng needed
        msg["kwargs"]["rng_key"] = None

    def postprocess_message(self, msg):
        # nested plates broadcast fine; nothing to undo
        pass


def config_enumerate(fn=None, default="parallel"):
    """Mark every finite-support latent site with
    ``infer={"enumerate": default}`` unless already configured
    (reference: contrib/funsor/infer_util.py:56)."""

    def config_fn(msg):
        if (
            msg["type"] == "sample"
            and not msg.get("is_observed", False)
            and getattr(msg["fn"], "has_enumerate_support", False)
            and msg["infer"].get("enumerate") is None
        ):
            return {"enumerate": default}
        return {}

    if fn is None:  # used as decorator factory
        return lambda f: config_enumerate(f, default=default)
    return infer_config(fn, config_fn=config_fn)


def markov(iterable=None, history=1):
    """History-limited dependency marker (reference:
    contrib/funsor/enum_messenger.py:630).  Enumerated sites visited in
    successive markov iterations recycle ``history + 1`` dims, so a length-T
    chain enumerates with bounded array rank; the density engine eliminates
    each recycled variable in site order (the forward algorithm).

    Usage (generator form)::

        for t in markov(range(T), history=1):
            z = sample(f"z_{t}", ..., infer={"enumerate": "parallel"})
    """
    if iterable is None:
        return _MarkovFrame(history)
    if isinstance(iterable, int):
        iterable = range(iterable)

    def _gen():
        frame = {"period": history + 1, "slot": 0, "base": None}
        _MARKOV_STACK.append(frame)
        try:
            for i, item in enumerate(iterable):
                frame["slot"] = i
                yield item
        finally:
            _MARKOV_STACK.remove(frame)

    return _gen()


class _MarkovFrame:
    """`with markov():` context form — each entry advances the slot."""

    def __init__(self, history):
        self.frame = {"period": history + 1, "slot": -1, "base": None}

    def __enter__(self):
        if self.frame not in _MARKOV_STACK:
            _MARKOV_STACK.append(self.frame)
        self.frame["slot"] += 1
        return self

    def __exit__(self, *args):
        return False
