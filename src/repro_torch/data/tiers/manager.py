"""Tier planning + metering: the HBM budget turned into window geometry;
the port's copy of ``repro.data.tiers.manager`` (pure Python).

The tiered corpus serves BET's expanding window out of three nested
levels — an HBM-resident *hot window*, a host-RAM shard ring, and the
disk shards — and the tier manager is the piece that decides
*which rows are hot*.  Its contract:

  * ``hot_cap`` is the largest **shard-aligned** row count the HBM byte
    budget admits (never more than the corpus).  Shard alignment is what
    keeps the append regime's shard-rounded residency inside the budget
    without per-append fixups.
  * While ``n_t <= hot_cap`` the stage window fits: the corpus runs the
    plain append-only regime, bit-compatible with the untiered plane.
  * Beyond that, the stage window ``[0, n_t)`` is swept in **disjoint
    stride-``hot_cap`` segments** ``[0, cap), [cap, 2cap), ...`` (the
    last one short).  Disjoint tiling is the zero-resident-reupload
    argument *by construction*: an incoming segment never overlaps the
    rows currently hot, so no resident byte is ever re-uploaded.  Full
    segments all share one shape, so B1 runs at one shape over the
    whole sweep.

``TierMeter`` is the tier plane's own accounting, kept separate from the
``data.shards.DataAccessMeter`` (which keeps metering disk
loads and device uploads exactly as before): promotions/evictions between
tiers, the double-buffer staging overlap, and the ``resident_reuploads``
counter the BENCH_scale claim is stated over.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TierMeter:
    """Counters for traffic *between* tiers (disk I/O and device uploads
    stay on the ``DataAccessMeter``).

    ``resident_reuploads`` counts examples uploaded to device while
    already hot — the tiling makes this structurally zero; the counter
    exists so the claim is measured, not assumed.  ``stage_time_s`` is
    staging wall time (submit -> committed); ``commit_block_s`` is the
    slice of it the driver actually waited — their ratio is the
    double-buffer's load/compute overlap."""
    promotions: int = 0
    promoted_examples: int = 0
    evictions: int = 0
    evicted_examples: int = 0
    resident_reuploads: int = 0
    staged_segments: int = 0
    staged_commits: int = 0
    staged_discards: int = 0
    direct_builds: int = 0
    stage_time_s: float = 0.0
    commit_block_s: float = 0.0

    def record_promotion(self, examples: int, *, reuploaded: int = 0) -> None:
        self.promotions += 1
        self.promoted_examples += int(examples)
        self.resident_reuploads += int(reuploaded)

    def record_eviction(self, examples: int) -> None:
        self.evictions += 1
        self.evicted_examples += int(examples)

    @property
    def staging_overlap(self) -> float:
        """Fraction of staging wall time hidden behind driver compute."""
        if self.stage_time_s <= 0.0:
            return 1.0 if self.staged_commits == 0 else 0.0
        return max(0.0, min(1.0,
                            1.0 - self.commit_block_s / self.stage_time_s))

    def snapshot(self) -> dict:
        d = dataclasses.asdict(self)
        d["staging_overlap"] = round(self.staging_overlap, 4)
        return d

    def restore(self, snap: dict) -> None:
        for f in dataclasses.fields(self):
            if f.name in snap:
                setattr(self, f.name,
                        type(getattr(self, f.name))(snap[f.name]))


class RingTierManager:
    """The default promotion/eviction plan: shard-aligned hot cap, stride
    tiling, host tier as a FIFO shard ring.

    Alternative managers (registered through
    ``repro_torch.api.register_tier_manager``) may pick different hot sets; the
    corpus only relies on ``hot_cap`` and ``segments`` returning disjoint
    in-order ranges covering ``[0, n_t)`` whose first boundary stride is
    shared across stages."""

    name = "ring"

    def __init__(self, *, hbm_bytes: int, row_bytes: int, shard_size: int,
                 capacity: int):
        if hbm_bytes < 1:
            raise ValueError(f"hbm_bytes must be >= 1, got {hbm_bytes}")
        if row_bytes < 1:
            raise ValueError(f"row_bytes must be >= 1, got {row_bytes}")
        rows = hbm_bytes // row_bytes
        if rows < shard_size:
            raise ValueError(
                f"hbm_bytes={hbm_bytes} holds only {rows} rows of "
                f"{row_bytes} bytes — below one shard ({shard_size} rows); "
                f"raise the budget or shrink shard_size")
        self.hbm_bytes = int(hbm_bytes)
        self.row_bytes = int(row_bytes)
        self.shard_size = int(shard_size)
        self.capacity = int(capacity)
        # shard-aligned *downward*: shard-rounded residency in the append
        # regime can then never overflow the byte budget
        self.hot_cap = min(self.capacity,
                           (rows // self.shard_size) * self.shard_size)

    def rotates(self, n_t: int) -> bool:
        """Does a stage window of ``n_t`` exceed the hot window?"""
        return n_t > self.hot_cap

    def segments(self, n_t: int) -> list[tuple[int, int]]:
        """Disjoint stride-``hot_cap`` tiling of ``[0, n_t)``, in sweep
        order.  Full segments share one shape (one B1 shape); only the
        final segment may be short."""
        cap = self.hot_cap
        if n_t <= cap:
            return [(0, n_t)]
        return [(lo, min(lo + cap, n_t)) for lo in range(0, n_t, cap)]
