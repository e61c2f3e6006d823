"""Geo-distributed serving engine: GeoTP's three techniques applied to a
multi-pod model-serving router (port of `repro.serving.engine`).

Mapping:
  DM (middleware)       -> the router
  data source           -> a pod serving a model replica (real decode steps)
  record lock           -> a KV-cache slot reservation on a pod
  distributed txn       -> a request fanned out to several pods (e.g.
                           cross-region redundant generation / verification)
  O1 decentralized prep -> pods finalize results immediately after generation
                           and ship result+ready in ONE message (baseline
                           routers confirm-then-commit: two WAN rounds)
  O2 latency-aware      -> the router delays dispatch to *near* pods by
                           (max tau - tau_p) + LEL forecast, Eq.(3)/(8), so
                           slot-occupancy windows align with the slowest pod
  O3 admission          -> Eq.(9) over per-pod (c,t,a) stats: requests that
                           would time out are rejected/deferred at the router

The event loop is the reference's deterministic heap scheduler (µs clock)
with the same numpy admission draws, so summaries equal the reference's.
Admission's Eq.(8)/Eq.(9) call goes through `core.scheduler.plan_dispatch`:
the `geo_schedule` kernel on the card, one [1, fanout] row per request. Each
`gen_done` runs one real decode step of the model on the engine's device
(the `decode_attention` kernel on the card for attention layers; the
recurrent mixers' O(1) state updates for mlstm / slstm / rglru). The engine
and its pools (nested recurrent states included) run on `device` (default:
the card).
"""


from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from repro_torch.core import scheduler as sched
from repro_torch.device import resolve_device
from repro_torch.models import model as mdl, stack
from repro_torch.models.config import ModelConfig
from repro_torch.models.schema import init_params
from repro_torch.serving.kvcache import SlotPool


@dataclasses.dataclass
class PodConfig:
    rtt_us: int
    n_slots: int = 16
    step_us: int = 2000  # decode-step service time model per batch tick


@dataclasses.dataclass
class Request:
    rid: int
    arrive_us: int
    gen_len: int
    fanout: list  # pod ids participating ("distributed txn")
    done_pods: set = dataclasses.field(default_factory=set)
    start_us: dict = dataclasses.field(default_factory=dict)
    finish_us: int = -1
    rejected: bool = False


@dataclasses.dataclass
class ServeStats:
    completed: int = 0
    rejected: int = 0
    lat_us: list = dataclasses.field(default_factory=list)
    occ_us: list = dataclasses.field(default_factory=list)  # slot occupancy windows


class GeoServingEngine:
    """Discrete-event geo-serving simulator driving real decode steps.

    `params` (the schema's weights, on `device`) replaces the weights
    `init_params` would draw from `seed`; the tests pass the reference's."""

    def __init__(
        self,
        cfg: ModelConfig,
        pods: list,
        *,
        policy: str = "geotp",  # "geotp" | "fcfs"
        seed: int = 0,
        run_model: bool = True,
        slot_timeout_us: int = 2_000_000,
        device=None,
        params: dict | None = None,
    ):
        self.cfg = cfg
        self.pods = pods
        self.policy = policy
        self.run_model = run_model
        self.slot_timeout_us = slot_timeout_us
        self.device = resolve_device(device)
        self.now = 0
        self.events: list = []  # (time, seq, kind, payload)
        self._seq = 0
        self.stats = ServeStats()
        self.pools = [SlotPool(cfg, p.n_slots, cfg.max_seq, self.device) for p in pods]
        self.queues: list = [[] for _ in pods]  # requests waiting for slots
        # O3 hotspot stats per pod (c_cnt, t_cnt, a_cnt) + EWMA queue wait
        self.c_cnt = np.zeros(len(pods), np.int64)
        self.t_cnt = np.zeros(len(pods), np.int64)
        self.a_cnt = np.zeros(len(pods), np.int64)
        self.wait_ewma_us = np.zeros(len(pods), np.float64)
        self.rng = np.random.default_rng(seed)
        if run_model:
            if params is None:
                gen = torch.Generator(device=self.device).manual_seed(seed)
                params = init_params(stack.build_schema(cfg), gen, self.device)
            self.params = stack.cast_weights(cfg, params)
            self.decode = mdl.make_decode_step(cfg)
        self.inflight: dict = {}

    # ---- event plumbing ----------------------------------------------------
    def _push(self, t: int, kind: str, payload):
        heapq.heappush(self.events, (t, self._seq, kind, payload))
        self._seq += 1

    # ---- GeoTP router logic --------------------------------------------------
    def submit(self, req: Request):
        self._push(req.arrive_us, "admit", req)

    def _row(self, x) -> torch.Tensor:
        """One [1, fanout] int32 row on the engine's device."""
        return torch.as_tensor(np.asarray(x).astype(np.int32)[None], device=self.device)

    def _admit(self, req: Request):
        taus = np.array([self.pods[p].rtt_us for p in req.fanout], np.int64)
        if self.policy == "geotp":
            # O2+O3 in one shared scheduling call (the same entry the
            # DE-engine sweeps and the Pallas kernel oracle go through):
            # Eq.(8) stagger — near pods dispatch later — and Eq.(9)
            # admission over the participating pods.
            lel = self.wait_ewma_us[req.fanout].astype(np.int64)
            inv = torch.ones((1, len(req.fanout)), dtype=torch.bool, device=self.device)
            off_t, p_abort_t = sched.plan_dispatch(
                self._row(taus),
                self._row(lel),
                inv,
                self._row(self.c_cnt[req.fanout]),
                self._row(self.t_cnt[req.fanout]),
                self._row(self.a_cnt[req.fanout]),
                inv,
            )
            if self.rng.random() < float(p_abort_t[0]):
                req.rejected = True
                self.stats.rejected += 1
                return
            off = off_t[0].cpu().numpy()
        else:
            off = np.zeros(len(req.fanout), np.int64)
        self.a_cnt[req.fanout] += 1
        for pod, o, tau in zip(req.fanout, off, taus):
            self._push(self.now + int(o) + tau // 2, "arrive_pod", (req, pod))

    def _arrive_pod(self, req: Request, pod: int):
        slots = self.pools[pod].reserve(1)
        if slots is None:
            self.queues[pod].append((self.now, req))
            self._push(self.now + self.slot_timeout_us, "slot_timeout", (req, pod))
            return
        self._start_gen(req, pod, slots)

    def _start_gen(self, req: Request, pod: int, slots: list):
        req.start_us[pod] = self.now
        step = self.pods[pod].step_us
        finish = self.now + step * req.gen_len
        self.inflight[(req.rid, pod)] = slots
        self._push(finish, "gen_done", (req, pod))

    def _gen_done(self, req: Request, pod: int):
        if self.run_model:
            # one real decode step stands in for the generation tick batch;
            # an encoder-decoder's runs its cross step over an empty memory
            # (enc_len = 0: zeros, no launch), as the reference's does
            tok = torch.zeros((1,), dtype=torch.int32, device=self.device)
            pos = torch.zeros((1,), dtype=torch.int32, device=self.device)
            cache = stack.init_cache(self.cfg, 1, 64, self.device)
            logits, _ = self.decode(self.params, tok, pos, cache)
            if not bool(torch.isfinite(logits.float()).all()):
                raise FloatingPointError(f"non-finite logits in a decode step on pod {pod}")
        slots = self.inflight.pop((req.rid, pod))
        self.pools[pod].release(slots)
        self.stats.occ_us.append(self.now - req.start_us[pod])
        # O3 statistics
        self.a_cnt[pod] = max(self.a_cnt[pod] - 1, 0)
        self.t_cnt[pod] += 1
        self.c_cnt[pod] += 1
        wait = self.now - req.start_us[pod]
        self.wait_ewma_us[pod] = 0.8 * self.wait_ewma_us[pod] + 0.2 * wait
        # wake a queued request
        if self.queues[pod]:
            t0, nxt = self.queues[pod].pop(0)
            slots2 = self.pools[pod].reserve(1)
            if slots2 is not None:
                self._start_gen(nxt, pod, slots2)
        # O1: result + ready in one message back to the router
        self._push(self.now + self.pods[pod].rtt_us // 2, "pod_ack", (req, pod))
        if self.policy != "geotp":
            # baseline two-round finalize: confirm + commit adds a WAN round
            self._push(self.now + 3 * self.pods[pod].rtt_us // 2, "pod_ack2", (req, pod))

    def _pod_ack(self, req: Request, pod: int, final: bool):
        if self.policy != "geotp" and not final:
            return  # waits for the second (commit) round
        req.done_pods.add(pod)
        if len(req.done_pods) == len(req.fanout) and req.finish_us < 0:
            req.finish_us = self.now
            self.stats.completed += 1
            self.stats.lat_us.append(self.now - req.arrive_us)

    def _slot_timeout(self, req: Request, pod: int):
        q = [(t, r) for (t, r) in self.queues[pod] if r.rid != req.rid]
        if len(q) != len(self.queues[pod]):
            self.queues[pod] = q
            self.a_cnt[pod] = max(self.a_cnt[pod] - 1, 0)
            self.t_cnt[pod] += 1  # completed (failed) access
            if not req.rejected:
                req.rejected = True
                self.stats.rejected += 1

    def run(self, until_us: int):
        while self.events and self.events[0][0] <= until_us:
            t, _, kind, payload = heapq.heappop(self.events)
            self.now = t
            if kind == "admit":
                self._admit(payload)
            elif kind == "arrive_pod":
                self._arrive_pod(*payload)
            elif kind == "gen_done":
                self._gen_done(*payload)
            elif kind == "pod_ack":
                self._pod_ack(*payload, final=False)
            elif kind == "pod_ack2":
                self._pod_ack(*payload, final=True)
            elif kind == "slot_timeout":
                self._slot_timeout(*payload)
        return self.summary()

    def summary(self) -> dict:
        lat = np.array(self.stats.lat_us) / 1000.0 if self.stats.lat_us else np.array([np.nan])
        occ = np.array(self.stats.occ_us) / 1000.0 if self.stats.occ_us else np.array([np.nan])
        return {
            "completed": self.stats.completed,
            "rejected": self.stats.rejected,
            "avg_latency_ms": float(np.mean(lat)),
            "p99_latency_ms": float(np.percentile(lat, 99)),
            "avg_slot_occupancy_ms": float(np.mean(occ)),
        }


def synthetic_workload(
    n: int, pods: int, *, dist_frac: float = 0.4, rate_per_s: float = 400.0, seed: int = 0
) -> list:
    rng = np.random.default_rng(seed)
    reqs = []
    t = 0.0
    for i in range(n):
        t += rng.exponential(1e6 / rate_per_s)
        fan = [int(rng.integers(pods))]
        if rng.random() < dist_frac and pods > 1:
            other = int(rng.integers(pods - 1))
            fan.append(other if other < fan[0] else other + 1)
        reqs.append(
            Request(rid=i, arrive_us=int(t), gen_len=int(rng.integers(4, 12)), fanout=fan)
        )
    return reqs
