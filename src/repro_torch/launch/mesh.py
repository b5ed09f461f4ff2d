"""Production meshes and the spec -> placements rule: the port of
``repro/launch/mesh.py``.

Meshes are ``torch.distributed.device_mesh.DeviceMesh`` objects with the
reference's axis names, made by FUNCTIONS: importing this module touches no
process group.  Each function needs a process group whose world size is
the mesh's size (the dry run starts a fake one, ``launch/dryrun.py``).

Single pod : (32, 8)     ("data", "model")        = 256 H100s
Multi-pod  : (2, 32, 8)  ("pod", "data", "model") = 512 H100s

The "model" axis (tensor and expert parallelism) stays inside one 8-GPU
NVLink node: tensor parallelism over InfiniBand is what an H100 cluster
avoids.  "data" spans the 32 nodes of a pod and carries FSDP parameter
sharding; "pod" carries only data-parallel gradient reductions (the one
traffic class that tolerates the slower inter-pod links).  The rules in
``launch/sharding.py`` name axes, not sizes, so they hold on any shape.

A spec is the reference's ``PartitionSpec`` as a tuple: one entry per
tensor dim, each ``None``, an axis name or a tuple of axis names.
``placements`` turns it into DTensor placements.
"""

from __future__ import annotations

from torch.distributed.tensor import Replicate, Shard

POD_SHAPE = (32, 8)
MULTIPOD_SHAPE = (2, 32, 8)


def mesh_name(multi_pod: bool) -> str:
    """The mesh's name in dry-run records."""
    return "multipod_2x32x8" if multi_pod else "pod_32x8"


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu"):
    """The pod or multi-pod mesh over the process group's ranks (256 or 512)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = MULTIPOD_SHAPE if multi_pod else POD_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1, device_type: str = "cuda"):
    """(world // model, model) ("data", "model") mesh over the process
    group's ranks: one card per rank with NCCL, CPU ranks with gloo."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"world size {n} does not split into model={model}")
    return init_device_mesh(device_type, (n // model, model), mesh_dim_names=("data", "model"))


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh, or of any object whose ``shape``
    is such a dict (the reference's meshes, the tests' stand-ins)."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh) -> tuple[str, ...]:
    """Axes that carry the batch: ("pod","data") on multi-pod else ("data",)."""
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))


def model_size(mesh) -> int:
    return axis_sizes(mesh)["model"]


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh, spec: tuple) -> tuple:
    """DTensor placements (one per mesh dim) for a spec.

    A tensor dim that names several axes is split by them in the order
    listed, the first outermost (JAX's order).  DTensor shards a dim over
    its mesh dims in mesh order, so the two agree only when the listed
    order is the mesh's; any other order raises.
    """
    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {dim} are not in the "
                             f"mesh's order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} shards two dims")
            out[i] = Shard(dim)
    return tuple(out)

