"""Collective forensics — the port of ``repro.launch.forensics``: trace one
combination with the dry run and print the top collective sites (wire
bytes × multiplicity, with provenance).

The reference reads the sites from the compiled HLO and names each by its
``op_name``; here they come from the dry run's traced step, each named by
the model file:line whose operation made DTensor redistribute (in the
backward pass: the autograd node and the forward line that made it), and
multiplied by the layers and time steps the dry run multiplies.

    PYTHONPATH=src python -m repro_torch.launch.forensics \\
        --arch falcon-mamba-7b --shape train_4k --policy fsdp_tp+act [--top 15]
"""
from __future__ import annotations

import argparse

from . import hlo as H


def collective_sites(result: dict) -> list:
    """(wire bytes × multiplicity, kind, output bytes, group size,
    multiplicity, provenance) for each collective site of a ``dry_run``
    result, largest first."""
    sites = []
    for kind, ob, n, site, mult in result["sites"]:
        wb = mult * H._wire_bytes(kind, ob, n)
        sites.append((wb, kind, ob, n, mult, site))
    sites.sort(reverse=True)
    return sites


def report(sites: list, top: int) -> list:
    """The reference's lines: a total, then one line a site."""
    tot = sum(s[0] for s in sites) or 1.0
    lines = [f"total wire bytes/device: {tot:.3e}  ({len(sites)} sites)"]
    for wb, coll, ob, n, mult, meta in sites[:top]:
        lines.append(f"{wb:9.2e} ({100*wb/tot:4.1f}%) {coll:18s} "
                     f"out={ob/1e6:9.1f}MB n={n:3d} x{mult:5.0f}  "
                     f"{meta[:120]}")
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--policy", default="fsdp_tp")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)

    from .dryrun import dry_run
    res = dry_run(args.arch, args.shape, multi_pod=args.multi_pod,
                  policy=args.policy)
    print("\n".join(report(collective_sites(res), args.top)))


if __name__ == "__main__":
    main()
