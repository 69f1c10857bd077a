"""The facts of the machine a run measured on: the host's CPU and cores,
the card's name, power limit and clocks. Host-bound numbers move between
card machines on unchanged code, so every run prints these."""

from __future__ import annotations

import os
import subprocess

GPU_QUERY = ("name,power.limit,power.draw,clocks.sm,clocks.max.sm,"
             "clocks.mem,temperature.gpu")


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def cores() -> dict:
    return {"logical": os.cpu_count(),
            "usable": len(os.sched_getaffinity(0))}


def nvidia_smi() -> list:
    """One line per card of nvidia-smi's reading of GPU_QUERY, or the
    error it gave."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={GPU_QUERY}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"nvidia-smi failed: {e}"]
    lines = out.stdout.strip().splitlines()
    return lines or [f"nvidia-smi printed nothing (exit {out.returncode})"]


def facts() -> dict:
    return {"cpu": cpu_model(), "cores": cores(), "gpus": nvidia_smi(),
            "gpu_fields": GPU_QUERY}
