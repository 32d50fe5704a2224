"""Device selection and the card banner.

Port of bz2tpu/utils/device.py. Selection is explicit: no device means
CUDA, and asking for CUDA where there is none raises; the CPU runs only
when a caller names it. Discovery comes from torch.cuda.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain torch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return proc.stdout.strip()


def device_info() -> list[dict]:
    """One dict per visible CUDA card (none where CUDA is unavailable)."""
    if not torch.cuda.is_available():
        return []
    return [
        {"id": i, "platform": "gpu", "kind": torch.cuda.get_device_name(i), "process": 0}
        for i in range(torch.cuda.device_count())
    ]


def print_device_banner(file=None) -> None:
    import sys

    file = file or sys.stderr
    infos = device_info()
    print(f"bz2tpu_torch: {len(infos)} device(s)", file=file)
    for i in infos:
        print(
            f"  [{i['id']}] {i['kind']} ({i['platform']}, process {i['process']})",
            file=file,
        )
    if infos:
        try:
            print(f"  nvidia-smi: {gpu_name_and_power_limit()}", file=file)
        except (OSError, subprocess.SubprocessError) as e:
            print(f"  nvidia-smi: unavailable ({e})", file=file)
