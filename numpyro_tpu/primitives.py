"""Model-DSL primitives and the effect-handler message stack.

Fresh implementation of the effect-handler runtime of NumPyro (reference:
numpyro/primitives.py).  The design survives unchanged because it is already
ideal for a traced-compilation PPL: the handler stack is plain Python that
only exists while the model is being *traced*; the compiled XLA program
contains none of it.  Messages are dicts routed bottom-up through
``process_message`` and top-down through ``postprocess_message``.
"""

from __future__ import annotations

import functools
import warnings
from collections import namedtuple
from contextlib import ExitStack, contextmanager

import jax.numpy as jnp
from jax import lax, random

import numpyro_tpu.distributions as dist
from numpyro_tpu.util import identity

_PYRO_STACK = []

CondIndepStackFrame = namedtuple(
    "CondIndepStackFrame", ["name", "dim", "size", "subsample_size"]
)


def default_process_message(msg):
    if msg["value"] is None:
        if msg["type"] == "sample":
            msg["value"], msg["intermediates"] = msg["fn"](
                *msg["args"], sample_intermediates=True, **msg["kwargs"]
            )
        else:
            msg["value"] = msg["fn"](*msg["args"], **msg["kwargs"])


def apply_stack(msg):
    """Route a message bottom-up (process) then top-down (postprocess); a
    handler setting ``msg["stop"]`` truncates the upward pass."""
    stop_at = 0  # index of the outermost handler that saw the message
    for idx in range(len(_PYRO_STACK) - 1, -1, -1):
        _PYRO_STACK[idx].process_message(msg)
        if msg.get("stop"):
            stop_at = idx
            break
    if msg["value"] is None:
        default_process_message(msg)

    # downward pass, only through handlers the message reached
    for idx in range(stop_at, len(_PYRO_STACK)):
        _PYRO_STACK[idx].postprocess_message(msg)
    return msg


class Messenger:
    """Base effect handler: a context manager that installs itself on the
    global stack; subclasses override process/postprocess_message."""

    def __init__(self, fn=None):
        if fn is not None and not callable(fn):
            raise ValueError(
                "Expected `fn` to be a Python callable object; "
                f"instead found type(fn) = {type(fn)}."
            )
        self.fn = fn
        functools.update_wrapper(self, fn, updated=[])

    def __enter__(self):
        _PYRO_STACK.append(self)
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        if exc_type is None:
            assert _PYRO_STACK[-1] is self
            _PYRO_STACK.pop()
        else:
            # on error, remove this handler and everything above it
            if self in _PYRO_STACK:
                loc = _PYRO_STACK.index(self)
                del _PYRO_STACK[loc:]

    def process_message(self, msg):
        pass

    def postprocess_message(self, msg):
        pass

    def __call__(self, *args, **kwargs):
        if self.fn is None:
            with self:
                return None
        with self:
            return self.fn(*args, **kwargs)


def _dispatch(msg_type, name=None, fn=identity, value=None, kwargs=None, **extras):
    """Build a message with protocol defaults and route it through the
    stack; every primitive below is a thin veneer over this."""
    msg = {
        "type": msg_type,
        "name": name,
        "fn": fn,
        "args": (),
        "kwargs": {} if kwargs is None else kwargs,
        "value": value,
        "cond_indep_stack": [],
    }
    msg.update(extras)
    return apply_stack(msg)


def _masked_observe(name, fn, obs, obs_mask, **kwargs):
    """Split a partially-observed site into observed + latent halves."""
    shape = kwargs["sample_shape"] + fn.shape()
    masked_fn = fn.mask(False)
    value = sample(f"{name}_unobserved", masked_fn, **kwargs)
    if obs is not None:
        value = jnp.where(
            jnp.reshape(obs_mask, jnp.shape(obs_mask) + (1,) * fn.event_dim)
            if fn.event_dim
            else obs_mask,
            obs,
            value,
        )
    sample(f"{name}_observed", fn, **kwargs, obs=value, obs_mask=None)
    return deterministic(name, value)


def sample(
    name,
    fn,
    obs=None,
    rng_key=None,
    sample_shape=(),
    infer=None,
    obs_mask=None,
):
    """Declare a random variable (reference: numpyro/primitives.py:144-251)."""
    assert isinstance(
        sample_shape, tuple
    ), "sample_shape needs to be a tuple of integers"
    if not isinstance(fn, dist.Distribution):
        type_error = TypeError(
            "It looks like you tried to use a fn that isn't an instance of "
            f"numpyro_tpu.distributions.Distribution, funsor.Funsor or "
            f"callable: {fn}"
        )
        if callable(fn):
            warnings.warn(
                "sample() fn should be a Distribution; got a bare callable",
                stacklevel=2,
            )
        else:
            raise type_error

    # no active handlers: draw directly
    if not _PYRO_STACK:
        if obs is None:
            if rng_key is None:
                raise ValueError(
                    "Cannot call `sample` outside an inference context without "
                    "an explicit rng_key."
                )
            return fn(rng_key=rng_key, sample_shape=sample_shape)
        else:
            return obs

    if obs_mask is not None:
        return _masked_observe(
            name, fn, obs, obs_mask, rng_key=rng_key, sample_shape=sample_shape, infer=infer
        )

    return _dispatch(
        "sample",
        name,
        fn,
        value=obs,
        kwargs={"rng_key": rng_key, "sample_shape": sample_shape},
        scale=None,
        is_observed=obs is not None,
        intermediates=[],
        infer={} if infer is None else infer,
    )["value"]


def param(name, init_value=None, **kwargs):
    """Declare an optimizable parameter (reference: primitives.py:254)."""
    if not _PYRO_STACK:
        assert not callable(init_value), (
            "A callable init_value needs to be put inside a numpyro_tpu handler."
        )
        return init_value

    if callable(init_value):
        def initial_fn(*args, **kw):
            return init_value(prng_key())
    else:
        def initial_fn(*args, **kw):
            return init_value

    return _dispatch(
        "param", name, initial_fn, kwargs=kwargs, scale=None
    )["value"]


def deterministic(name, value):
    """Record a deterministic function of other sites in the trace."""
    if not _PYRO_STACK:
        return value

    return _dispatch(
        "deterministic", name, lambda *a, **k: value, value=value
    )["value"]


def mutable(name, init_value=None):
    """A mutable state site (threaded through SVI steps)."""
    if not _PYRO_STACK:
        return init_value
    return _dispatch(
        "mutable", name, lambda *a, **k: init_value, value=init_value
    )["value"]


def get_mask():
    """The effective mask at the current point in the handler stack."""
    return _dispatch("inspect", fn=lambda: True, mask=None)["mask"]


def factor(name, log_factor):
    """Add an arbitrary log-density term via a Unit-distribution site."""
    unit_dist = dist.Unit(log_factor)
    unit_value = jnp.zeros(jnp.shape(log_factor) + (0,))
    sample(name, unit_dist, obs=unit_value, infer={"is_auxiliary": True})


def prng_key():
    """Draw a fresh PRNG key from the innermost seed handler."""
    if not _PYRO_STACK:
        return

    return _dispatch(
        "prng_key", fn=lambda rng_key: rng_key, kwargs={"rng_key": None}
    )["value"]


def subsample(data, event_dim):
    """Subselect ``data`` along the active plate dims (reference:
    primitives.py:691)."""
    if not _PYRO_STACK:
        return data

    assert isinstance(event_dim, int) and event_dim >= 0
    return _dispatch(
        "subsample",
        fn=lambda *a, **k: data,
        value=data,
        kwargs={"event_dim": event_dim},
    )["value"]


class plate(Messenger):
    """Conditional-independence context: allocates a negative batch dim,
    broadcasts sample sites into it, scales log-prob under subsampling, and
    subselects ``param``/``subsample`` values (reference: primitives.py:467).
    """

    def __init__(self, name, size, subsample_size=None, dim=None):
        self.name = name
        assert size > 0, "size of plate should be positive"
        self.size = size
        if dim is not None and dim >= 0:
            raise ValueError("dim arg must be negative.")
        self.dim, self._indices = self._subsample(
            self.name, self.size, subsample_size, dim
        )
        self.subsample_size = self._indices.shape[0]
        super().__init__()

    @staticmethod
    def _subsample_fn(size, subsample_size, rng_key=None):
        if rng_key is None:
            raise ValueError(
                "Missing random key to generate subsample indices. "
                "Algorithms like HMC/NUTS do not support subsampling; "
                "use HMCECS instead."
            )
        # random.choice without replacement via top-k on uniform keys:
        # O(size) fused, accelerator-friendly (no Fisher-Yates serial swaps)
        u = random.uniform(rng_key, (size,))
        _, idx = lax.top_k(u, subsample_size)
        return idx

    @staticmethod
    def _subsample(name, size, subsample_size, dim):
        msg = _dispatch(
            "plate",
            name,
            plate._subsample_fn,
            value=(
                None
                if (subsample_size is not None and size != subsample_size)
                else jnp.arange(size)
            ),
            kwargs={"rng_key": None},
            args=(size, subsample_size),
            scale=1.0,
        )
        subsample = msg["value"]
        subsample_size = msg["args"][1]
        if subsample_size is not None and subsample_size != subsample.shape[0]:
            warnings.warn(
                "subsample_size does not match len(subsample), {} vs {}.".format(
                    subsample_size, len(subsample)
                )
                + " Did you accidentally use different subsample_size in the model and guide?",
                stacklevel=2,
            )
        cond_indep_stack = msg["cond_indep_stack"]
        occupied_dims = {f.dim for f in cond_indep_stack}
        if dim is None:
            new_dim = -1
            while new_dim in occupied_dims:
                new_dim -= 1
            dim = new_dim
        else:
            assert dim not in occupied_dims
        return dim, subsample

    def __enter__(self):
        super().__enter__()
        return self._indices

    def _frame(self):
        return CondIndepStackFrame(
            self.name, self.dim, self.size, self.subsample_size
        )

    def _broadcast_into_frame(self, msg):
        """Expand a sample site's batch shape to cover every enclosing
        plate dim (any explicit sample_shape folds into the batch)."""
        stack = msg["cond_indep_stack"]
        rank = max(-f.dim for f in stack)
        plate_shape = [1] * rank
        for f in stack:
            plate_shape[f.dim] = f.subsample_size
        fn_shape = msg["fn"].batch_shape
        sample_shape = msg["kwargs"].get("sample_shape", ())
        if sample_shape:
            fn_shape = sample_shape + fn_shape
            msg["kwargs"]["sample_shape"] = ()
        head = max(rank - len(fn_shape), 0)
        tail = lax.broadcast_shapes(tuple(plate_shape[head:]), tuple(fn_shape))
        msg["fn"] = msg["fn"].expand(tuple(plate_shape[:head]) + tail)

    def process_message(self, msg):
        kind = msg["type"]
        if kind == "control_flow":
            raise NotImplementedError(
                "Cannot use control flow primitive under a `plate` primitive."
            )
        if kind not in ("param", "sample", "plate", "deterministic"):
            # "subsample" messages are subselected in postprocess_message
            return
        msg["cond_indep_stack"].append(self._frame())
        if kind == "deterministic":
            return
        if kind == "sample":
            self._broadcast_into_frame(msg)
        if self.size != self.subsample_size:
            # subsampled plate: inflate the minibatch log-prob to an
            # unbiased full-data estimate
            correction = self.size / self.subsample_size if self.subsample_size else 1
            msg["scale"] = (
                correction
                if msg["scale"] is None
                else msg["scale"] * correction
            )

    def postprocess_message(self, msg):
        if msg["type"] not in ("subsample", "param") or self.dim is None:
            return
        if msg.get("_pregathered"):
            # an outer cache handler already substituted the subselected
            # panel (HMCECS hoists the gather out of the leapfrog loop)
            return
        event_dim = msg["kwargs"].get("event_dim")
        if event_dim is None:
            return
        assert event_dim >= 0
        axis = self.dim - event_dim
        shape = jnp.shape(msg["value"])
        if len(shape) < -axis or shape[axis] == 1:
            return
        if shape[axis] != self.size:
            if msg["type"] == "param":
                statement = (
                    f"numpyro_tpu.param({msg['name']}, ..., event_dim={event_dim})"
                )
            else:
                statement = f"numpyro_tpu.subsample(..., event_dim={event_dim})"
            raise ValueError(
                f"Inside plate({self.name}, {self.size}, "
                f"subsample_size={self.subsample_size}) "
                f"invalid shape of {statement}: {shape}"
            )
        if self.subsample_size < self.size:
            msg["value"] = jnp.take(msg["value"], self._indices, axis)


@contextmanager
def plate_stack(prefix, sizes, rightmost_dim=-1):
    """A stack of nested plates occupying dims [rightmost_dim - len(sizes),
    rightmost_dim]."""
    assert rightmost_dim < 0
    with ExitStack() as stack:
        for i, size in enumerate(reversed(sizes)):
            plate_i = plate(f"{prefix}_{len(sizes) - i - 1}", size, dim=rightmost_dim - i)
            stack.enter_context(plate_i)
        yield


def module(name, nn, input_shape=None):
    """Declare a Stax-style (init_fn, apply_fn) module; registers params."""
    module_key = name + "$params"
    nn_init, nn_apply = nn
    nn_params = param(module_key)
    if nn_params is None:
        if input_shape is None:
            raise ValueError("Valid value for `input_shape` needed to initialize.")
        rng_key = prng_key()
        _, nn_params = nn_init(rng_key, input_shape)
        param(module_key, nn_params)
    return functools.partial(nn_apply, nn_params)


def flax_module(*args, **kwargs):
    from numpyro_tpu.contrib.module import flax_module as _impl

    return _impl(*args, **kwargs)
