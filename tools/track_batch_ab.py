#!/usr/bin/env python3
"""Protocol configs tracked in microbatches of 8 and one frame at a time, in
one process on one card.

    python3 tools/track_batch_ab.py [1 4 6 7] [--device cuda]

For each config named (default 1 4 6 7) runs the protocol runner's config
function twice, at `track_batch` 8 (PipelineConfig's default) and then at 1,
and prints each run's JSON line with "track_batch" set, then the card's
`nvidia-smi` line. Config 1 takes `track_batch` as an argument; configs 2-7
build their pipeline through `protocols.make_pipeline`, which this script
wraps to replace the config's `track_batch`. Both runs of a config share
the process, the card and the kernels built for it, so their frames/s and
wall seconds compare; the runs of one config are not interleaved with
another's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bundleadjustment_tpu_torch.bench import card_line, device_name, protocols  # noqa: E402


def run(name, track_batch, device):
    if name == "1":
        return protocols.config1(track_batch=track_batch, device=device)
    make = protocols.make_pipeline

    def make_at(cfg, *args, **kw):
        return make(dataclasses.replace(cfg, track_batch=track_batch), *args, **kw)

    protocols.make_pipeline = make_at
    try:
        return protocols.PROTOCOLS[name](device=device)
    finally:
        protocols.make_pipeline = make


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", default=["1", "4", "6", "7"],
                    help="protocols 1-7 (default 1 4 6 7)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from bundleadjustment_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    smi = card_line(device)
    for name in args.names:
        for tb in (8, 1):
            out = run(name, tb, device)
            out["track_batch"] = tb
            out["device"] = device_name(device)
            out["nvidia_smi"] = smi
            print(json.dumps(out), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
