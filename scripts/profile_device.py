#!/usr/bin/env python
"""Where an encode's device time goes, from a profiler trace of one warm
encode on the GPU.

    python scripts/profile_device.py [--seconds 10] [--compact] [--kernel on|off]

Encodes the bench fixture (bench.make_signal) once to compile, then traces
one more encode and reduces the trace to device busy time, the device's
idle share of the encode's wall time, and device time per named region of
the encode core (models/encode.py: lobe_scan, refine, exact_scan; the
global pass's refine shares the `refine` scope). Regions are found through
XLA's optimized-HLO dump: each device op's (program, instruction) maps to
the op_name metadata that carries the jax.named_scope path.

Prints one line per region and the 12 longest ops; refuses any backend
but the GPU.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
REGIONS = ("lobe_scan", "refine", "exact_scan")
KERNEL = "fwav_scan_topc"  # ops/pallas_search.py's pallas_call name


def _hlo_op_names(dump_dir):
    """{(program_id, name): op_name} and {instruction: op_name} from the
    optimized-HLO text dump. `name` is the instruction name and the GPU
    kernel name XLA derives from it ('.' -> '_'): ops captured in a CUDA
    graph report hlo_op "command_buffer", so only their kernel name maps.
    The Pallas kernel is found by its own name in the op_name path."""
    by_prog, by_name = {}, {}
    inst = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name=\"([^\"]*)\"")
    for path in glob.glob(os.path.join(dump_dir, "*after_optimizations.txt")):
        m = re.match(r"module_(\d+)\.", os.path.basename(path))
        prog = int(m.group(1)) if m else -1
        with open(path) as f:
            for line in f:
                mm = inst.match(line)
                if mm:
                    name, op_name = mm.groups()
                    by_prog[(prog, name)] = op_name
                    by_prog.setdefault((prog, name.replace(".", "_")), op_name)
                    by_name.setdefault(name, op_name)
                    if f"/{KERNEL}/" in op_name:
                        by_prog[(prog, KERNEL)] = op_name
    return by_prog, by_name


def _device_events(trace_dir):
    from jax.profiler import ProfileData

    path = glob.glob(os.path.join(trace_dir, "plugins/profile/*/*.xplane.pb"))[0]
    pd = ProfileData.from_file(path)
    events, seen = [], set()
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        names = [line.name for line in plane.lines]
        # per-op events live on "XLA Ops" when the profiler derives it,
        # else on the raw stream lines
        want = ({"XLA Ops"} if "XLA Ops" in names
                else {n for n in names if n.startswith("Stream")})
        for line in plane.lines:
            if line.name not in want:
                continue
            for ev in line.events:
                key = (ev.start_ns, ev.duration_ns, ev.name)
                if key in seen:  # one op can appear on several lines
                    continue
                seen.add(key)
                stats = dict(ev.stats)
                events.append((ev.start_ns, ev.duration_ns, ev.name,
                               stats.get("hlo_op", ev.name),
                               stats.get("program_id", -1)))
    return events


def _busy_ns(events):
    spans = sorted((s, s + d) for s, d, *_ in events)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--compact", action="store_true",
                    help="the damped --compact profile (default: balanced)")
    ap.add_argument("--kernel", choices=("on", "off"), default="on")
    args = ap.parse_args()

    work = os.path.join(ROOT, ".smoke")
    os.makedirs(work, exist_ok=True)
    dump = tempfile.mkdtemp(prefix="profile_", dir=work)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_dump_to={dump} --xla_dump_hlo_as_text")
    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"profile_device: needs the GPU, JAX runs on "
                 f"{jax.default_backend()!r}")
    from bench import make_signal
    from fwav.config import EncoderConfig
    from fwav.models.codec import STREAMING_THRESHOLD
    from fwav.models.encode import compress_audio_arrays
    from fwav.models.stream import compress_audio_streaming
    # every program must compile here: a persistent-cache hit would leave
    # no HLO dump to map the trace through
    jax.config.update("jax_enable_compilation_cache", False)
    sr = 44100
    sig = make_signal(args.seconds, sr)
    objective = "damped" if args.compact else "balanced"
    cfg = EncoderConfig(objective=objective, use_pallas=args.kernel == "on")
    if len(sig) > STREAMING_THRESHOLD:
        def encode():
            return compress_audio_streaming(sig, sr, 2, config=cfg)
    else:
        def encode():
            return compress_audio_arrays(sig, sr, 2, config=cfg)

    encode()  # compile
    trace_dir = os.path.join(dump, "trace")
    with jax.profiler.trace(trace_dir):
        t0 = time.perf_counter()
        encode()
        wall = time.perf_counter() - t0

    by_prog, by_name = _hlo_op_names(dump)
    events = _device_events(trace_dir)
    busy = _busy_ns(events)
    d = jax.devices()[0]
    tag = (f"{args.seconds:g}s {'compact' if args.compact else 'default'} "
           f"kernel={args.kernel} [{d.device_kind}]")
    print(f"profile {tag}: encode_wall_s={wall:.4f} device_busy_s="
          f"{busy * 1e-9:.4f} idle_share={1 - busy * 1e-9 / wall:.4f} "
          f"device_events={len(events)}", flush=True)
    per_region = {r: 0.0 for r in REGIONS}
    per_op = {}
    unmapped = 0.0
    for _s, dur, name, hlo_op, prog in events:
        op_name = (by_prog.get((prog, hlo_op)) or by_prog.get((prog, name))
                   or by_name.get(hlo_op))
        if op_name is None:
            unmapped += dur
        else:
            for r in REGIONS:
                if f"/{r}/" in f"/{op_name}/":
                    per_region[r] += dur
                    break
        key = (name, (op_name or "?")[-90:])
        per_op[key] = per_op.get(key, 0.0) + dur
    total = sum(dur for _s, dur, *_ in events) or 1.0
    for r, t in per_region.items():
        print(f"profile {tag}: region {r} device_s={t * 1e-9:.5f} "
              f"share_of_device_time={t / total:.4f}", flush=True)
    print(f"profile {tag}: unmapped device_s={unmapped * 1e-9:.5f}", flush=True)
    for (name, op_name), t in sorted(per_op.items(), key=lambda kv: -kv[1])[:12]:
        print(f"profile {tag}:   {t * 1e-9:.5f} s  {name}  {op_name}", flush=True)


if __name__ == "__main__":
    main()
