#!/usr/bin/env python3
"""Run one cell of the port's benchmark:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (portbench/README.md). The last line printed is
the result's JSON object.
"""
import os
import sys
import time


def process_age() -> float:
    """Seconds since this process started (Linux /proc), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


# the run's process keeps to a fixed set of this many cores: the steps are
# bound by the host's launches, and a process that migrates over all of a
# shared host's cores spreads more from run to run
CORES = 4


def pin_cores():
    """Keep this process (and the threads it starts) on its first CORES
    available cores, where the platform allows it."""
    try:
        cores = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, cores[:CORES])
    except (AttributeError, OSError):
        pass


if __name__ == "__main__":
    t_start = time.perf_counter() - process_age()
    pin_cores()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from portbench import harness
    sys.exit(harness.main(t_start=t_start))
