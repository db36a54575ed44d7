"""CPUDEFAULT: public functions of the port whose device defaults to the
CPU: 3 findings."""
import torch


def init_params(n, device="cpu"):
    return torch.zeros(n, device=device)


def init_cache(n, *, device=torch.device("cpu")):
    return torch.zeros(n, device=device)


class Engine:
    def warm(self, device="cpu"):
        return device
