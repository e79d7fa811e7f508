"""The port's measurement runners: the protocol runner (`protocols`, configs
1-7, the fresh-process checkpoint/resume protocol 6r and the seed sweep) and
the solve and frontend bench (`solve`). Each prints one JSON line a run.
The helpers below are theirs: the card's name and `nvidia-smi` line, the
kernels loaded before a clock starts, a synchronize that ends a timed
region."""

import subprocess


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_name(device):
    """The card's name (`torch.cuda.get_device_name`) or "cpu"."""
    import torch

    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def load_kernels(device):
    """Build and load every CUDA kernel library (nvcc at first use) for a
    run on the card, so that no build lands inside a timed region."""
    from bundleadjustment_tpu_torch import kernels
    from bundleadjustment_tpu_torch.device import resolve_device

    if resolve_device(device).type == "cuda":
        kernels.build_all()
        for name in kernels.SIGNATURES:
            kernels.lib(name)


def card_line(device):
    """`nvidia-smi`'s name and power limit of the card, printed before a run
    on it; None on the CPU."""
    import torch

    if torch.device(device).type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
