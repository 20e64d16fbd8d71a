"""Hardware constants of the port's target, the NVIDIA H100 SXM, for the
roofline of ``core.gpu_adapter`` and the dry run's analytic model.

Counterpart of ``repro.launch.mesh``, whose v5e constants these names
follow: ``PEAK_FLOPS_BF16``, ``HBM_BW``, ``ICI_BW`` and ``HBM_BYTES`` hold
the H100's figures (data sheet), and ``Hardware`` bundles them so a caller
can pass another card's (the tests pass the reference's v5e numbers).

The mesh constructors build a ``DeviceMesh`` over the ranks of the
current process group (``launch.ranks`` starts them), with the
reference's axis names. ``make_host_mesh`` is the reference's tiny mesh
over whatever ranks exist; ``make_production_mesh`` is the port's
production mesh, the four-card host's (a deviation from the reference's
16 x 16 v5e pod, ROADMAP): ``model`` 4 on the cards of one NVLink host,
``data`` over the hosts, and with ``multi_pod`` every host of four cards
on ``pod``. They are functions, so importing this module touches no
process group and no CUDA.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM hardware constants (per card), from the data sheet.
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense bf16 on the tensor cores
HBM_BW = 3.35e12                  # bytes/s, HBM3
ICI_BW = 450e9                    # bytes/s, NVLink 4: 900 GB/s per card
                                  # both ways, this is one direction
HBM_BYTES = 80e9                  # 80 GB of HBM3 per card


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One accelerator's roofline constants (per chip or card)."""
    peak_flops_bf16: float        # FLOP/s
    hbm_bw: float                 # bytes/s
    ici_bw: float                 # bytes/s of the chip-to-chip links
    hbm_bytes: float              # device memory, bytes


H100 = Hardware(PEAK_FLOPS_BF16, HBM_BW, ICI_BW, HBM_BYTES)

CARDS_PER_HOST = 4                # model axis of the production mesh


def _world() -> int:
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: start the ranks "
                           "with repro_torch.launch.ranks")
    return dist.get_world_size()


def make_host_mesh(model: int = 1, device: str = "cuda"):
    """(data, model) = (world // model, model) over the process group's
    ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    n = _world()
    if n % model:
        raise ValueError(f"model axis {model} does not divide {n} ranks")
    return init_device_mesh(device, (n // model, model),
                            mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The four-card host's mesh: (data, model) = (world // 4, 4); with
    ``multi_pod``, (pod, data, model) = (world // 4, 1, 4), one host of
    four cards per pod."""
    from torch.distributed.device_mesh import init_device_mesh
    n = _world()
    if n % CARDS_PER_HOST:
        raise ValueError(f"the production mesh takes hosts of "
                         f"{CARDS_PER_HOST} cards, not {n} ranks")
    hosts = n // CARDS_PER_HOST
    if multi_pod:
        return init_device_mesh(device, (hosts, 1, CARDS_PER_HOST),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh(device, (hosts, CARDS_PER_HOST),
                            mesh_dim_names=("data", "model"))
