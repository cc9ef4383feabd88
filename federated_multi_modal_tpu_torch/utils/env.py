"""Environment report (port of ``federated_multi_modal_tpu/utils/env.py``,
Dassl's ``collect_env_info``): Python, torch, CUDA and the card, with its
power limit, where the JAX package reports JAX and its devices."""

import platform
import subprocess
import sys


def _card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return out.stdout.strip() or f"unavailable ({out.stderr.strip()})"


def collect_env_info() -> str:
    lines = [
        f"python: {sys.version.split()[0]}",
        f"platform: {platform.platform()}",
    ]
    import numpy as np
    import torch

    lines.append(f"torch: {torch.__version__}")
    lines.append(f"torch cuda: {torch.version.cuda}")
    if torch.cuda.is_available():
        lines.append(f"cuda devices: {torch.cuda.device_count()} x "
                     f"{torch.cuda.get_device_name(0)}")
        lines.append(f"card (name, power limit): {_card_line()}")
    else:
        lines.append("cuda devices: none")
    lines.append(f"numpy: {np.__version__}")
    return "\n".join(lines)
