"""Batched GeoTP scheduler kernel: Eq.(8) stagger offsets + Eq.(9) p_abort."""
