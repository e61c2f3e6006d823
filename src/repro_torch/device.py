"""Device selection: the port runs on the card unless told otherwise; and the
one reader of the card's name and power limit."""

from __future__ import annotations

import subprocess

import torch

SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
# where a kernel wrapper computes by its kernel's plain version: the CPU, and
# `meta` (the planning tools' trace: shapes and dtypes, no storage, no kernel)
PLAIN_DEVICES = ("cpu", "meta")


def resolve_device(device=None) -> torch.device:
    """`None` means ``"cuda"``. A CUDA request without a usable card raises:
    the port never falls back to the CPU on its own — pass ``device="cpu"``
    to run there (the tests do)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default, but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU explicitly"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    return dev


def plain_device(x: torch.Tensor) -> bool:
    """Whether a kernel wrapper takes its plain version for `x` (a CPU or a
    `meta` tensor); a CUDA tensor launches the kernel or raises."""
    return x.device.type in PLAIN_DEVICES


def smi_line(device=0) -> str:
    """The line `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    prints for the card torch calls `device` (e.g. ``NVIDIA H100 80GB HBM3,
    700.00 W``). The card is picked by its UUID (``-i GPU-<uuid>``), not by
    torch's index: nvidia-smi ignores CUDA_VISIBLE_DEVICES and lists every
    card of the host. Raises if the tool fails or prints another count of
    lines than one."""
    uuid = torch.cuda.get_device_properties(device).uuid
    out = subprocess.run([*SMI_QUERY, "-i", f"GPU-{uuid}"], capture_output=True, text=True,
                         check=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    if len(lines) != 1:
        raise RuntimeError(f"nvidia-smi -i GPU-{uuid} printed {len(lines)} lines, not one")
    return lines[0].strip()


def card_info(device=None) -> dict:
    """``device_name`` and ``power_limit`` of the device a run used, as
    nvidia-smi prints them; on the CPU ``"cpu"`` and None (no limit is
    read, so none is written)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return {"device_name": "cpu", "power_limit": None}
    name, limit = (x.strip() for x in smi_line(dev).rsplit(",", 1))
    return {"device_name": name, "power_limit": limit}
