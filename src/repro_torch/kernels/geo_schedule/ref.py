"""Plain PyTorch version of the `geo_schedule` kernel.

The same op order as `scheduler.stagger_offsets` + `scheduler.abort_probability`
(it calls them): the CPU path of the wrapper, and what `chip_smoke.py`
holds the CUDA kernel against on the card.
"""

from __future__ import annotations


def geo_schedule_ref(tau, lel, inv, c_cnt, t_cnt, a_cnt, valid):
    """tau/lel [N,D] int32 µs, inv [N,D] bool, c/t/a_cnt [N,K] int32,
    valid [N,K] bool -> (offsets [N,D] int32, p_abort [N] float32)."""
    from repro_torch.core import scheduler as sched

    off = sched.stagger_offsets(tau, inv, lel)
    p = sched.abort_probability(c_cnt, t_cnt, a_cnt, valid)
    return off, p
