"""Device and dtype policy of the port (counterpart of the device parts of
bigclam_tpu/utils/dist.py and bigclam_tpu/utils/compat.py).

* Entry points run on `cuda` unless the caller passes `device="cpu"`.
  When no card is present they raise DeviceUnavailableError: they never
  carry on on the CPU by themselves.
* float64 is a CPU parity dtype (the float64 tests against the JAX package
  and its spec interpreter); on the card F is float32.
* TF32 is off: any plain float32 matrix product runs in full float32, as
  the JAX package's kernels use Precision.HIGHEST
  (bigclam_tpu/ops/pallas_csr.py:42-45).
"""

from __future__ import annotations

from typing import Optional, Union

import torch


class DeviceUnavailableError(RuntimeError):
    """A cuda device was asked for (explicitly or by default) and none is
    present."""


def disable_tf32() -> None:
    """Full-float32 matrix products and convolutions (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: `cuda` by default, or what the
    caller names. Raises DeviceUnavailableError for cuda without a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (use cuda or cpu)")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                "no CUDA device is available; pass device='cpu' "
                "(`--device cpu`) to run the plain PyTorch path on the CPU"
            )
        disable_tf32()
    return dev


def resolve_dtype(name: str, device: torch.device) -> torch.dtype:
    """F dtype from the config's name: float32 anywhere, float64 on the
    CPU only (parity runs)."""
    if name == "float32":
        return torch.float32
    if name == "float64":
        if device.type != "cpu":
            raise ValueError(
                "float64 is the CPU parity dtype; F is float32 on cuda"
            )
        return torch.float64
    raise ValueError(f"unsupported dtype {name!r}")


def device_kind(device: torch.device) -> str:
    """Human-readable device identity for results: the card's name, or
    'cpu'."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
