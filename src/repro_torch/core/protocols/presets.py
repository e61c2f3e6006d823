"""The protocol zoo: the paper's systems under test + related-work designs.

The engine is a single state machine parameterized by `ProtocolConfig`; each
baseline in the evaluation is a preset registered here:

  SSP          — ShardingSphere: XA/2PC coordinated by the DM. Distributed commit
                 costs 2 WAN rounds (prepare + commit); centralized txns use
                 one-phase commit (1 round).
  SSP_LOCAL    — ShardingSphere 'local' mode: decentralized commit without
                 atomicity guarantees (no prepare phase at all).
  SCALARDB     — middleware-level concurrency control: locks are managed at the
                 DM, every operation is an individual WAN round trip, ops execute
                 sequentially across the whole transaction, 2PC on top.
  QURO         — SSP + op reordering (writes as late as possible). The reordering
                 itself is applied to the workload bank (workloads.quro_reorder).
  CHILLER      — prepare merged into execution (like O1) + two-stage region
                 scheduling: intra-region (lowest-RTT) subtxns first, cross-region
                 after they complete (per the paper's description §I/§VII-A-1).
  YUGA         — distributed-database-style baseline (Fig 13): merged prepare +
                 asynchronous apply for centralized (single-shard) transactions
                 (locks released right after local commit, no commit round).
  GEOTP_O1     — decentralized prepare + early abort only.
  GEOTP_O12    — + latency-aware scheduling, Eq.(3).
  GEOTP        — + high-contention heuristics (LEL forecast Eq.(8), late txn
                 scheduling Eq.(9)) == the full system (O1~O3).

Related-work commit paths (ROADMAP "Protocol zoo"; measured via the
`wan_rounds` counter — see docs/architecture.md for the per-design table):

  FASTC        — Fast Commitment (arxiv 2312.01229): the geo-agent acts as
                 co-coordinator and decides commit next to the data after the
                 final statement round, cutting the DM commit-log broadcast
                 round out of the decentralized path entirely.
  TIGA         — Tiga (arxiv 2509.05759): statements are future-timestamped
                 with a synchronized-clock deadline; single-round transactions
                 whose statements all arrive before the deadline (clock skew
                 included) execute at the deadline and commit in one WAN
                 round. A deadline miss at any participant falls back to the
                 decentralized slow path.
  OPTA         — optimistic aborts (arxiv 1610.07459): a lock conflict aborts
                 the requester immediately instead of blocking in the wait
                 queue, trading aborts (bounded retries) for commit latency
                 under contention.
"""

from __future__ import annotations

from repro_torch.core.protocols.base import (
    PREPARE_COORD,
    PREPARE_DECENTRAL,
    PREPARE_NONE,
    STAGGER_NET,
    STAGGER_NET_LEL,
    STAGGER_NONE,
    ProtocolConfig,
)
from repro_torch.core.protocols.registry import register_preset

SSP = register_preset(
    ProtocolConfig(
        name="ssp", prepare=PREPARE_COORD, stagger=STAGGER_NONE, admission=False, early_abort=False
    )
)
SSP_LOCAL = register_preset(
    ProtocolConfig(
        name="ssp-local",
        prepare=PREPARE_NONE,
        stagger=STAGGER_NONE,
        admission=False,
        early_abort=False,
    )
)
SCALARDB = register_preset(
    ProtocolConfig(
        name="scalardb",
        prepare=PREPARE_COORD,
        stagger=STAGGER_NONE,
        admission=False,
        early_abort=False,
        middleware_cc=True,
    )
)
QURO = register_preset(
    ProtocolConfig(
        name="quro", prepare=PREPARE_COORD, stagger=STAGGER_NONE, admission=False, early_abort=False
    )
)
CHILLER = register_preset(
    ProtocolConfig(
        name="chiller",
        prepare=PREPARE_DECENTRAL,
        stagger=STAGGER_NONE,
        admission=False,
        early_abort=False,
        chiller_two_stage=True,
    )
)
YUGA = register_preset(
    ProtocolConfig(
        name="yugabyte-like",
        prepare=PREPARE_DECENTRAL,
        stagger=STAGGER_NONE,
        admission=False,
        early_abort=False,
        async_local_commit=True,
    )
)
GEOTP_O1 = register_preset(
    ProtocolConfig(name="geotp-o1", prepare=PREPARE_DECENTRAL, stagger=STAGGER_NONE, admission=False)
)
GEOTP_O12 = register_preset(
    ProtocolConfig(name="geotp-o1o2", prepare=PREPARE_DECENTRAL, stagger=STAGGER_NET, admission=False)
)
GEOTP = register_preset(
    ProtocolConfig(name="geotp", prepare=PREPARE_DECENTRAL, stagger=STAGGER_NET_LEL)
)

# ---- related-work commit paths ----------------------------------------------
FASTC = register_preset(
    ProtocolConfig(
        name="fastc",
        prepare=PREPARE_DECENTRAL,
        stagger=STAGGER_NONE,
        admission=False,
        early_abort=False,
        co_commit=True,
        # single-shard txns also commit at the co-coordinator (no DM round)
        async_local_commit=True,
    )
)
TIGA = register_preset(
    ProtocolConfig(
        name="tiga",
        prepare=PREPARE_DECENTRAL,
        stagger=STAGGER_NONE,
        admission=False,
        early_abort=False,
        async_local_commit=True,
        # deadline = dispatch + slack; sized so one-way WAN delays up to
        # ~150 ms arrive "in the future" under zero clock skew
        tiga_slack_us=150_000,
    )
)
OPTA = register_preset(
    ProtocolConfig(
        name="opta",
        prepare=PREPARE_DECENTRAL,
        stagger=STAGGER_NONE,
        admission=False,
        early_abort=True,  # conflict aborts fan out geo-agent-to-geo-agent
        opt_abort=True,
        max_retries=2,  # optimistic aborts need retries for liveness
    )
)
