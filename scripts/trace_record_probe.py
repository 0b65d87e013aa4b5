"""Count the device records a torch.profiler window loses, late in a
``chip_smoke.py`` run and in a fresh process, for a window opened plainly
(``torch.profiler.profile``) and through ``repro_torch.obs.warm_profile``.

    python3 scripts/trace_record_probe.py [--traces 12]

Needs one CUDA card.  It runs a copy of ``chip_smoke.py`` that stops where
the telemetry phase starts its traced rounds (the process has then served,
trained and profiled every earlier path) and opens there, ``--traces``
times each, four kinds of window:

  plain       ``profile()`` over 40 launches of a small in-place multiply
  warm        ``warm_profile()`` over the same
  plain_round ``profile()`` over one femnist-iid round (its gather first)
  trace_if    ``obs.trace_if`` over one femnist-iid round

then the same four in a fresh process (``--fresh``).  A launch or copy
whose host call is in the window and whose device record (the same
correlation id) is not, is lost.  Prints one JSON line a kind and place:
the windows with a loss, the lost counts, and the windows that lost every
record.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANCHOR = "        stages = {}\n        no_upload = STAGES[:2] + STAGES[3:]\n"


def lost_records(path):
    """(calls in the window, calls whose device record is missing)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    device = {e["args"].get("correlation") for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")}
    calls = [e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and ("aunch" in e["name"] or "emcpy" in e["name"]
                  or "emset" in e["name"])]
    return len(calls), sum(e["args"].get("correlation") not in device
                           for e in calls)


def windows(torch, srv, n, tmp, place):
    """Open ``n`` windows of each kind; print a JSON line a kind."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import trace_if, warm_profile
    x = torch.zeros(1 << 16, device="cuda")

    def launches():
        for _ in range(40):
            x.mul_(1.0001)
        torch.cuda.synchronize()

    def one_round():
        srv.run_round(srv.cfg.rounds)
        torch.cuda.synchronize()

    plain = lambda: profile(activities=[ProfilerActivity.CPU,  # noqa: E731
                                        ProfilerActivity.CUDA])
    kinds = {"plain": (plain, launches), "warm": (warm_profile, launches),
             "plain_round": (plain, one_round)}
    rows = {k: [] for k in (*kinds, "trace_if")}
    for i in range(n):
        for kind, (opener, body) in kinds.items():
            with opener() as prof:
                body()
            path = os.path.join(tmp, f"{place}_{kind}_{i}.json")
            prof.export_chrome_trace(path)
            rows[kind].append(lost_records(path))
        tdir = os.path.join(tmp, f"{place}_trace_if_{i}")
        with trace_if(tdir):
            one_round()
        (name,) = os.listdir(tdir)
        rows["trace_if"].append(lost_records(os.path.join(tdir, name)))
    for kind, got in rows.items():
        lost = [m for _, m in got]
        print(json.dumps(dict(place=place, kind=kind, windows=n,
                              with_loss=sum(m > 0 for m in lost),
                              whole=sum(m > 0 and m == c for c, m in got),
                              calls=[c for c, _ in got], lost=lost)),
              flush=True)


def femnist_server(torch):
    from repro_torch.core.server import FedSAEServer, ServerConfig
    from repro_torch.data.federated import make_femnist_like
    srv = FedSAEServer(make_femnist_like(), cfg=ServerConfig(
        algo="ira", n_selected=10, rounds=5, sampling="iid"))
    srv.run()
    torch.cuda.synchronize()
    return srv


def late_probe(torch, tmp, off, n):
    """Called from the patched ``chip_smoke.py`` in place of its traced
    rounds: the late windows, then the fresh process's."""
    windows(torch, off, n, tmp, "late")
    done = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--fresh", "--traces", str(n)], timeout=600)
    if done.returncode:
        raise RuntimeError(f"fresh probe: rc {done.returncode}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--traces", type=int, default=12)
    ap.add_argument("--fresh", action="store_true",
                    help="open the windows in this process, fresh")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("trace_record_probe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory(prefix="trace_probe_") as tmp:
        if args.fresh:
            windows(torch, femnist_server(torch), args.traces, tmp, "fresh")
            return 0
        with open(os.path.join(ROOT, "chip_smoke.py")) as f:
            src = f.read()
        if src.count(ANCHOR) != 1:
            raise SystemExit("chip_smoke.py no longer has the traced "
                             "rounds' anchor line")
        here = os.path.dirname(os.path.abspath(__file__))
        src = src.replace(
            "HERE = os.path.dirname(os.path.abspath(__file__))",
            f"HERE = {ROOT!r}", 1).replace(ANCHOR, (
                f"        sys.path.insert(0, {here!r})\n"
                f"        import trace_record_probe\n"
                f"        trace_record_probe.late_probe(torch, tmp, off, "
                f"{args.traces})\n        raise SystemExit(0)\n"), 1)
        copy = os.path.join(tmp, "chip_smoke_probe.py")
        with open(copy, "w") as f:
            f.write(src)
        return subprocess.run([sys.executable, copy]).returncode


if __name__ == "__main__":
    sys.exit(main())
