"""The paper's own model configs (retrieval / ESR / LSR / HSTU-GR) at the
repo's width (torch port of ``repro/configs/roo_models.py``).

``attn_backend`` selects the HSTU attention backend (kernels/dispatch.py);
None = auto (the CUDA kernel on a CUDA tensor, torch-chunked elsewhere).
"""
from typing import Optional

from repro_torch.core.hstu import HSTUConfig
from repro_torch.models.gr import GRConfig
from repro_torch.models.lsr import LSRConfig
from repro_torch.models.two_tower import TwoTowerConfig

N_ITEMS = 50000


def retrieval_config(hstu: bool = True,
                     attn_backend: Optional[str] = None) -> TwoTowerConfig:
    return TwoTowerConfig(
        n_items=N_ITEMS, user_tower_mode="hstu" if hstu else "mlp",
        hstu=HSTUConfig(d_model=64, n_heads=2, d_qk=32, d_v=32, n_layers=2,
                        max_rel_pos=64,
                        attn_backend=attn_backend) if hstu else None)


def esr_config(hstu: bool = True,
               attn_backend: Optional[str] = None) -> TwoTowerConfig:
    return TwoTowerConfig(
        n_items=N_ITEMS, esr_head=True,
        user_tower_mode="hstu" if hstu else "mlp",
        hstu=HSTUConfig(d_model=64, n_heads=2, d_qk=32, d_v=32, n_layers=2,
                        max_rel_pos=64,
                        attn_backend=attn_backend) if hstu else None)


def gr_config(hist_len: int = 64, m_targets: int = 16,
              attn_backend: Optional[str] = None, d_model: int = 64,
              n_heads: int = 2, d_qk: int = 32, d_v: int = 32,
              n_layers: int = 2,
              max_rel_pos: Optional[int] = None) -> GRConfig:
    """hstu-gr ranking; the HSTU widths default to the repo's, the rab
    table to the history window (``max_rel_pos`` None)."""
    return GRConfig(n_items=N_ITEMS, hist_len=hist_len, m_targets=m_targets,
                    hstu=HSTUConfig(d_model=d_model, n_heads=n_heads,
                                    d_qk=d_qk, d_v=d_v, n_layers=n_layers,
                                    max_rel_pos=(hist_len if max_rel_pos
                                                 is None else max_rel_pos),
                                    attn_backend=attn_backend))


def lsr_config(mode: str = "userarch_hstu",
               attn_backend: Optional[str] = None) -> LSRConfig:
    return LSRConfig(n_items=N_ITEMS, mode=mode, attn_backend=attn_backend)
