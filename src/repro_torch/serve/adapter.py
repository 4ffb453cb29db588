"""ServeAdapter — the contract between a model architecture and the scoring
engine (a copy of ``repro/serve/adapter.py``, framework-free).

  * ``score(params, batch)`` — the fused forward; the only required entry
    point. Stateless archs stop here.
  * ``user_repr`` / ``score_from_user`` — the RO/NRO split, memoized by the
    user-tower cache (serve/user_cache.py ``UserTowerCache``).
  * ``init_user_state`` / ``extend_user_state`` / ``score_from_state`` —
    the stateful hooks for incremental serving: per-user K/V state persisted
    across requests (``UserStateStore``), so a repeat user costs O(new
    events). ``state_hist_len`` is the history capacity the state covers;
    the engine requires it to equal the batcher window.

The port's engine consumes all three capabilities: ``supports_user_cache``
gates the memoized split path, ``supports_incremental`` the state-store
path, and everything else runs the fused ``score``.
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
      * init_user_state() -> per-user state record (no batch axis)
      * extend_user_state(params, batch, state, *, n_new) -> state
      * score_from_state(params, batch, state, *, n_new) -> (scores, state)
        where ``state`` carries a leading batch axis and ``n_new`` is the
        new-event row budget.
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

    # -- the reference's older names for the halves --------------------------
    @property
    def score_fn(self) -> Callable:
        return self.score

    @property
    def user_fn(self) -> Optional[Callable]:
        return self.user_repr
