"""CPUDEFAULT: public entry points default to the card; private helpers
may default to the CPU."""
import torch


def init_params(n, device="cuda"):
    return torch.zeros(n, device=device)


def _host_copy(t, device="cpu"):
    return t.to(device)


class _Helper:
    def run(self, device="cpu"):
        return device
