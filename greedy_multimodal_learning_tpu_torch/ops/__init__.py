from .mmtm_gating import mmtm_gating, mmtm_gating_plain
