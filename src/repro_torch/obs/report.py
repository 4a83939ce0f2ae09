"""End-of-run ``RunReport`` — the BENCH claims recomputed from events alone;
the port's copy of ``repro.obs.report``.

A run instrumented through :mod:`repro_torch.obs.events` leaves one JSONL stream.
``RunReport`` folds that stream — and nothing else — back into the numbers
the repo's BENCH claims are stated over: the per-stage table of compute vs.
blocked-load vs. flush time, the Thm 4.1 access accounting, every expansion
decision with the statistics the policy saw, and the §3.3 resource claims
(≤ 1 host transfer per stage, prefetch overlap, zero resident re-upload,
per-host loads == owned slice).  ``matches_meter`` then cross-checks the
event-derived totals against a live ``DataAccessMeter`` snapshot: if the two
disagree, either the instrumentation or the meters are lying, and the claim
pipeline says which numbers diverged instead of silently picking one.

Event vocabulary consumed here (all emitted by the instrumented stack):

  ``run.meta``             run-level constants (n, hosts, row_bytes, …)
  ``stage.acquire``        span: window residency wait
  ``stage.compute``        span: one device chunk (kernel + device_get)
  ``stage.flush``          span: collective flush / trace landing
  ``checkpoint.publish``   span: atomic stage checkpoint write
  ``stage.totals``         counter: cumulative clock/engine state per stage
  ``engine.transfer``      instant: one device->host pull
  ``expand.decision``      instant: the policy's verdict + observed stats
  ``stage.host_records``   instant: all-gathered per-host cumulative I/O
  ``meter.load/upload/access``  instant: mirrored DataAccessMeter updates
  ``serve.tick/ingest/hold/swap/staleness``  the serving side
"""
from __future__ import annotations

import json
import math
import os

from . import events as ev

#: DataAccessMeter integer fields recomputed from ``meter.*`` events.
_METER_INTS = ("bytes_loaded", "examples_loaded", "loads", "prefetched_loads",
               "bytes_uploaded", "examples_uploaded", "uploads",
               "examples_accessed")
_METER_FLOATS = ("load_time_s", "blocked_time_s")


def _stage_of(e: dict):
    tags = e.get("tags") or {}
    if "stage" in tags:
        return tags["stage"]
    return (e.get("fields") or {}).get("stage")


class RunReport:
    """Per-stage accounting and claim recomputation over one event stream."""

    def __init__(self, events: list[dict]):
        self.events = list(events)
        self.meta: dict = {}
        self._by_name: dict[str, list[dict]] = {}
        for e in self.events:
            self._by_name.setdefault(e["name"], []).append(e)
        metas = self._by_name.get("run.meta")
        if metas:
            self.meta = dict(metas[0].get("fields") or {})

    # ------------------------------------------------------------ constructors
    @classmethod
    def from_recorder(cls, recorder) -> "RunReport":
        return cls(recorder.event_dicts())

    @classmethod
    def from_jsonl(cls, path) -> "RunReport":
        return cls(ev.from_jsonl(path))

    @classmethod
    def from_events(cls, events) -> "RunReport":
        return cls([e.to_dict() if hasattr(e, "to_dict") else e
                    for e in events])

    def named(self, name: str) -> list[dict]:
        return self._by_name.get(name, [])

    # -------------------------------------------------------- meter recompute
    def meter_totals(self) -> dict:
        """The full ``DataAccessMeter.snapshot()`` recomputed from the
        mirrored ``meter.*`` events alone (same derived-field edge cases)."""
        d = {k: 0 for k in _METER_INTS}
        d.update({k: 0.0 for k in _METER_FLOATS})
        for e in self.named("meter.load"):
            f = e["fields"]
            d["bytes_loaded"] += int(f["nbytes"])
            d["examples_loaded"] += int(f["examples"])
            d["loads"] += 1
            d["prefetched_loads"] += int(bool(f["prefetched"]))
            d["load_time_s"] += float(f["duration_s"])
            d["blocked_time_s"] += float(f["blocked_s"])
        for e in self.named("meter.upload"):
            f = e["fields"]
            d["bytes_uploaded"] += int(f["nbytes"])
            d["examples_uploaded"] += int(f["examples"])
            d["uploads"] += 1
        for e in self.named("meter.access"):
            d["examples_accessed"] += int(e["fields"]["examples"])
        d["overlap_fraction"] = round(self.overlap_fraction(), 4)
        d["reuse_ratio"] = round(
            d["examples_accessed"] / max(1, d["examples_loaded"]), 2)
        return d

    def overlap_fraction(self) -> float:
        """§3.3 load/compute overlap from ``meter.load`` events, mirroring
        ``DataAccessMeter.overlap_fraction``'s edge cases exactly."""
        loads = self.named("meter.load")
        load_s = sum(float(e["fields"]["duration_s"]) for e in loads)
        blocked_s = sum(float(e["fields"]["blocked_s"]) for e in loads)
        if load_s <= 0.0:
            return 1.0 if not loads else 0.0
        return max(0.0, min(1.0, 1.0 - blocked_s / load_s))

    def matches_meter(self, snapshot: dict) -> bool:
        """Do the event-derived totals reproduce a live meter snapshot?
        Integers must match exactly; float time sums to 1e-9 relative."""
        return not self.meter_mismatches(snapshot)

    def meter_mismatches(self, snapshot: dict) -> list[str]:
        mine = self.meter_totals()
        out = []
        for k in _METER_INTS:
            if int(mine[k]) != int(snapshot.get(k, -1)):
                out.append(f"{k}: events={mine[k]} meter={snapshot.get(k)}")
        for k in _METER_FLOATS + ("overlap_fraction", "reuse_ratio"):
            if not math.isclose(float(mine[k]),
                                float(snapshot.get(k, math.nan)),
                                rel_tol=1e-9, abs_tol=1e-12):
                out.append(f"{k}: events={mine[k]} meter={snapshot.get(k)}")
        return out

    # ------------------------------------------------------------ stage table
    def stage_rows(self) -> list[dict]:
        """One row per stage: window/steps, the clock deltas, and where the
        wall time went (compute vs. acquire-blocked vs. flush vs. publish)."""
        spans: dict[str, dict[object, float]] = {}
        for name in ("stage.compute", "stage.acquire", "stage.flush",
                     "checkpoint.publish"):
            per: dict[object, float] = {}
            for e in self.named(name):
                s = _stage_of(e)
                per[s] = per.get(s, 0.0) + float(e.get("dur") or 0.0)
            spans[name] = per
        loads: dict[object, dict] = {}
        for e in self.named("meter.load"):
            s = _stage_of(e)
            agg = loads.setdefault(s, {"load_s": 0.0, "blocked_s": 0.0,
                                       "bytes": 0, "examples": 0})
            f = e["fields"]
            agg["load_s"] += float(f["duration_s"])
            agg["blocked_s"] += float(f["blocked_s"])
            agg["bytes"] += int(f["nbytes"])
            agg["examples"] += int(f["examples"])
        uploads: dict[object, dict] = {}
        for e in self.named("meter.upload"):
            s = _stage_of(e)
            agg = uploads.setdefault(s, {"bytes": 0, "examples": 0})
            agg["bytes"] += int(e["fields"]["nbytes"])
            agg["examples"] += int(e["fields"]["examples"])
        decisions: dict[object, dict] = {}
        for e in self.named("expand.decision"):
            decisions[_stage_of(e)] = dict(e["fields"])

        rows, prev = [], {"time": 0.0, "accesses": 0, "loaded": 0,
                          "transfers": 0}
        for e in self.named("stage.totals"):
            f, s = e["fields"], _stage_of(e)
            ld = loads.get(s, {})
            up = uploads.get(s, {})
            rows.append({
                "stage": s,
                "window": f.get("window"),
                "steps": f.get("steps"),
                "compute_s": round(spans["stage.compute"].get(s, 0.0), 6),
                "acquire_s": round(spans["stage.acquire"].get(s, 0.0), 6),
                "flush_s": round(spans["stage.flush"].get(s, 0.0), 6),
                "checkpoint_s": round(
                    spans["checkpoint.publish"].get(s, 0.0), 6),
                "load_s": round(ld.get("load_s", 0.0), 6),
                "blocked_s": round(ld.get("blocked_s", 0.0), 6),
                "bytes_loaded": ld.get("bytes", 0),
                "examples_loaded": ld.get("examples", 0),
                "bytes_uploaded": up.get("bytes", 0),
                "examples_uploaded": up.get("examples", 0),
                "transfers": int(f.get("transfers", 0)) - prev["transfers"],
                "clock_time": round(float(f.get("time", 0.0))
                                    - prev["time"], 6),
                "clock_accesses": int(f.get("accesses", 0))
                - prev["accesses"],
                "clock_loaded": int(f.get("loaded", 0)) - prev["loaded"],
                "expand": decisions.get(s),
            })
            prev = {"time": float(f.get("time", 0.0)),
                    "accesses": int(f.get("accesses", 0)),
                    "loaded": int(f.get("loaded", 0)),
                    "transfers": int(f.get("transfers", 0))}
        return rows

    def expansions(self) -> list[dict]:
        """Every expansion decision with the statistics the policy acted on."""
        return [{"stage": _stage_of(e), **(e.get("fields") or {})}
                for e in self.named("expand.decision")]

    # ---------------------------------------------------------------- thm 4.1
    def thm41(self) -> dict:
        """Thm 4.1 accounting: simulated-clock charges next to the metered
        real I/O — O(1/ε) accesses over O(N) loads is the paper's claim."""
        totals = self.named("stage.totals")
        last = totals[-1]["fields"] if totals else {}
        m = self.meter_totals()
        return {
            "stages": len(totals),
            "clock_time": last.get("time"),
            "clock_accesses": last.get("accesses"),
            "clock_loaded": last.get("loaded"),
            "examples_loaded": m["examples_loaded"],
            "examples_accessed": m["examples_accessed"],
            "reuse_ratio": m["reuse_ratio"],
            "n": self.meta.get("n"),
        }

    # ----------------------------------------------------------------- claims
    def claims(self) -> dict:
        """The key BENCH claims recomputed from the event stream alone.
        ``None`` means the stream lacks the inputs (e.g. no ``run.meta``)."""
        totals = self.named("stage.totals")
        stages = len(totals)
        transfers = int(totals[-1]["fields"].get("transfers", 0)) \
            if totals else 0
        out = {
            "le_one_transfer_per_stage":
                transfers <= stages if stages else None,
            "overlap_ge_half": self.overlap_fraction() >= 0.5,
        }
        row_bytes = self.meta.get("row_bytes")
        if row_bytes:
            out["zero_resident_reupload"] = all(
                r["bytes_uploaded"] == r["examples_uploaded"] * row_bytes
                for r in self.stage_rows())
        else:
            out["zero_resident_reupload"] = None
        n = self.meta.get("n")
        m = self.meter_totals()
        out["each_example_loaded_once"] = \
            (m["examples_loaded"] == n) if n else None
        recs = self.named("stage.host_records")
        if recs:
            final = recs[-1]["fields"]
            hosts = final.get("hosts") or []
            ok = sum(int(h.get("examples_loaded", 0))
                     for h in hosts) == m["examples_loaded"]
            if n is not None and final.get("n_t") == n:
                # final window covers the corpus: every host's cumulative
                # loads must equal exactly its owned prefix slice
                ok = ok and all(int(h.get("examples_loaded", -1))
                                == int(h.get("window", -2)) for h in hosts)
            out["per_host_loads_are_owned_slice"] = ok
        else:
            out["per_host_loads_are_owned_slice"] = \
                out["each_example_loaded_once"]
        return out

    # ------------------------------------------------------------------ tiers
    def tier_summary(self) -> dict | None:
        """The tier plane, when present: promotions/evictions, the
        measured resident-reupload count, and the last occupancy sample
        (``None`` on untiered runs — the report stays byte-identical)."""
        promotes = self.named("tier.promote")
        occ = self.named("tier.occupancy")
        if not promotes and not occ:
            return None
        last = occ[-1]["fields"] if occ else {}
        return {
            "promotions": len(promotes),
            "promoted_examples": sum(int(e["fields"].get("examples", 0))
                                     for e in promotes),
            "staged": sum(1 for e in promotes
                          if e["fields"].get("source") == "staged"),
            "direct": sum(1 for e in promotes
                          if e["fields"].get("source") == "direct"),
            "evictions": len(self.named("tier.evict")),
            "discards": len(self.named("tier.discard")),
            "resident_reuploads": int(last.get("resident_reuploads", 0)),
            "occupancy": last,
        }

    # ------------------------------------------------------------------ serve
    def serve_summary(self) -> dict | None:
        """The serving side, when present: tick time, ingest volume, stage
        holds, hot swaps with latency, staleness samples."""
        ticks = self.named("serve.tick")
        if not ticks and not self.named("serve.ingest"):
            return None
        swaps = self.named("serve.swap")
        stal = [e["fields"].get("staleness")
                for e in self.named("serve.staleness")]
        return {
            "ticks": len(ticks),
            "serve_wall_s": round(sum(float(e.get("dur") or 0.0)
                                      for e in ticks), 6),
            "ingested_examples": sum(int(e["fields"].get("examples", 0))
                                     for e in self.named("serve.ingest")),
            "holds": len(self.named("serve.hold")),
            "swaps": [{"stage": e["fields"].get("stage"),
                       "latency_s": e["fields"].get("latency_s")}
                      for e in swaps],
            "staleness_samples": stal,
            "max_staleness": max([s for s in stal if s is not None],
                                 default=0),
        }

    # ------------------------------------------------------------- rendering
    def to_dict(self) -> dict:
        out = {
            "meta": self.meta,
            "stages": self.stage_rows(),
            "thm41": self.thm41(),
            "claims": self.claims(),
            "meter": self.meter_totals(),
            "expansions": self.expansions(),
            "num_events": len(self.events),
        }
        serve = self.serve_summary()
        if serve is not None:
            out["serve"] = serve
        tiers = self.tier_summary()
        if tiers is not None:
            out["tiers"] = tiers
        return out

    def to_text(self) -> str:
        """The per-stage table + claim verdicts, printable for both train
        and serve runs."""
        cols = ("stage", "window", "steps", "compute_s", "acquire_s",
                "flush_s", "checkpoint_s", "blocked_s", "load_s",
                "transfers", "clock_accesses")
        rows = self.stage_rows()
        cells = [[str(r.get(c, "")) for c in cols] for r in rows]
        widths = [max(len(c), *(len(row[i]) for row in cells))
                  if cells else len(c) for i, c in enumerate(cols)]
        lines = ["  ".join(c.rjust(w) for c, w in zip(cols, widths))]
        lines += ["  ".join(v.rjust(w) for v, w in zip(row, widths))
                  for row in cells]
        t = self.thm41()
        lines.append("")
        lines.append(
            f"thm4.1: {t['stages']} stages, "
            f"clock accesses={t['clock_accesses']}, "
            f"loaded={t['clock_loaded']}, metered "
            f"examples_loaded={t['examples_loaded']} "
            f"accessed={t['examples_accessed']} "
            f"(reuse {t['reuse_ratio']}x, n={t['n']})")
        lines.append(f"overlap_fraction={self.overlap_fraction():.4f}")
        for k, v in self.claims().items():
            verdict = "PASS" if v else ("n/a" if v is None else "FAIL")
            lines.append(f"claim {k}: {verdict}")
        tiers = self.tier_summary()
        if tiers is not None:
            lines.append(
                f"tiers: {tiers['promotions']} promotions "
                f"({tiers['staged']} staged, {tiers['direct']} direct), "
                f"{tiers['evictions']} evictions, "
                f"resident reuploads {tiers['resident_reuploads']}")
        serve = self.serve_summary()
        if serve is not None:
            lines.append(
                f"serve: {serve['ticks']} ticks "
                f"({serve['serve_wall_s']}s), "
                f"{serve['ingested_examples']} examples ingested, "
                f"{serve['holds']} holds, {len(serve['swaps'])} swaps, "
                f"max staleness {serve['max_staleness']}")
        return "\n".join(lines)

    def save(self, directory) -> dict:
        """Write ``report.json`` + ``report.txt``; returns the paths."""
        os.makedirs(directory, exist_ok=True)
        jpath = os.path.join(directory, "report.json")
        tpath = os.path.join(directory, "report.txt")
        with open(jpath, "w") as fh:
            json.dump(self.to_dict(), fh, indent=2, default=ev._json_safe)
        with open(tpath, "w") as fh:
            fh.write(self.to_text() + "\n")
        return {"json": jpath, "txt": tpath}
