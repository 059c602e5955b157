"""Activation-layout hints read by the model forwards.

Ported from the reference's ``repro/distributed/hints.py``.  The model code
stays mesh-agnostic: a launcher installs a spec for the residual stream
(sequence parallelism: ``(dp, tp, None)``) or for the MoE ``[E, C, d]``
dispatch buffer, and the forwards pass their tensors through
:func:`constrain` and :func:`constrain_moe_buffer` at the reference's
points.

In the reference a spec carries its mesh and XLA lays the tensor out.  The
port's tensors are one device's share, so the sharded program
(``distributed/program.py``) reads an installed spec: the residual
stream's at :func:`constrain`, the MoE buffer's when the program plans its
MoE modules (the buffer's exchanges are ``program.moe_dispatch``'s, just
after :func:`constrain_moe_buffer`).  With no spec installed, or no
program, both return their input itself: no op runs and no bit moves.
"""

from __future__ import annotations

import contextlib

_ACTIVATION_PSPEC: tuple | None = None
_MOE_BUFFER_PSPEC: tuple | None = None


def set_activation_pspec(spec) -> None:
    global _ACTIVATION_PSPEC
    _ACTIVATION_PSPEC = spec


def get_activation_pspec():
    return _ACTIVATION_PSPEC


@contextlib.contextmanager
def activation_pspec(spec):
    prev = _ACTIVATION_PSPEC
    set_activation_pspec(spec)
    try:
        yield
    finally:
        set_activation_pspec(prev)


def constrain(x):
    """Lay the residual stream out by the installed spec (input unchanged
    when none is installed)."""
    spec = _ACTIVATION_PSPEC
    if spec is None:
        return x
    from repro_torch.distributed import program

    return program.constrain(x, spec)


def get_moe_buffer_pspec():
    return _MOE_BUFFER_PSPEC


@contextlib.contextmanager
def moe_buffer_pspec(spec):
    """The layout of the MoE ``[E, C, d]`` dispatch buffer, ``(experts,
    capacity, None)``: the dry-run installs ``("model", "data", None)`` for
    its ``@seqpar-ep`` cells (dispatch-aware sharding, the reference's).  A
    program built while it is installed lays the buffer out by it."""
    global _MOE_BUFFER_PSPEC
    prev = _MOE_BUFFER_PSPEC
    _MOE_BUFFER_PSPEC = spec
    try:
        yield
    finally:
        _MOE_BUFFER_PSPEC = prev


def constrain_moe_buffer(buf):
    """The MoE buffer at the reference's point (``models/moe.py``), returned
    itself: the installed program laid its exchanges out by the spec
    installed when it was built (``program.moe_dispatch``, the next call).
    Raises if that spec is not the one installed now."""
    spec = _MOE_BUFFER_PSPEC
    if spec is None:
        return buf
    from repro_torch.distributed import program

    prog = program.current()
    if prog is not None and prog.moe_spec != spec:
        raise ValueError(f"the MoE buffer spec {spec} was installed after the program was built "
                         f"with {prog.moe_spec}")
    return buf
