"""ServeAdapter — the contract between a model architecture and the scoring
engine (a copy of ``repro/serve/adapter.py``, framework-free).

  * ``score(params, batch)`` — the fused forward; the only required entry
    point, and the only one the port's engine consumes so far.
  * ``user_repr`` / ``score_from_user`` — the RO/NRO split for the
    user-tower cache.
  * ``init_user_state`` / ``extend_user_state`` / ``score_from_state`` —
    the stateful hooks for incremental serving; ``state_hist_len`` is the
    history capacity the state covers.

The user-tower cache and the incremental state store are not ported yet,
so the port's engine calls ``score`` only.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class ServeAdapter:
    """Serving entry points of one architecture (see module docstring).

    Callable signatures:
      * score(params, batch) -> (B_NRO,) | (B_NRO, n_tasks)
      * user_repr(params, batch) -> (B_RO, ...)
      * score_from_user(params, batch, user) -> like ``score``
      * init_user_state() -> per-user state (no batch axis)
      * extend_user_state(params, batch, state, *, n_new) -> state
      * score_from_state(params, batch, state, *, n_new) -> (scores, state)
    """
    score: Callable
    user_repr: Optional[Callable] = None
    score_from_user: Optional[Callable] = None
    init_user_state: Optional[Callable] = None
    extend_user_state: Optional[Callable] = None
    score_from_state: Optional[Callable] = None
    state_hist_len: int = 0

    @property
    def supports_user_cache(self) -> bool:
        """True when the RO/NRO split halves are available."""
        return (self.user_repr is not None
                and self.score_from_user is not None)

    @property
    def supports_incremental(self) -> bool:
        """True when the stateful hooks are available."""
        return (self.init_user_state is not None
                and self.score_from_state is not None
                and self.state_hist_len > 0)
