"""Production mesh builders: the port of ``repro/launch/mesh.py`` on
``torch.distributed``'s ``DeviceMesh``.

Functions, not module-level constants: importing this module touches no
device and no process group. A mesh needs a default process group whose
world is the mesh's size; one process has one default group, so each
world lives in a process of its own (or is torn down before the next).

  * :func:`fake_world` — the ``"fake"`` backend on a ``FakeStore`` plus a
    ``FakeTensorMode``: rank 0 of a world of any size, where collectives
    return at once and tensors carry shapes but no data. The counterpart
    of the reference's ``--xla_force_host_platform_device_count=512``: the
    dry run traces the production meshes inside it.
  * :func:`make_host_mesh` — the 1×1 mesh over one card (a world of 1 over
    NCCL, started here if none is), or over the CPU (gloo) when asked.
  * :func:`make_production_mesh` / :func:`make_test_mesh` — the
    reference's shapes over whatever world is running.

:func:`~repro_torch.parallel.sharding.mesh_shape` reads a ``DeviceMesh``,
a ``StageMesh`` or a plain ``{axis: size}`` dict alike, so the sharding
rules need no process group at all.
"""
from __future__ import annotations

import contextlib

import torch


def _device_type(devices) -> str:
    """``devices`` as a ``DeviceMesh`` device type: a device or its type
    name as given; else that of the running world's backend (gloo and the
    fake backend: ``"cpu"``; NCCL: ``"cuda"``)."""
    if devices is not None:
        return torch.device(devices).type
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def compat_make_mesh(shape, axes, devices=None):
    """``init_device_mesh`` over the default process group, with named axes
    (the reference's ``jax.make_mesh`` with Auto axis types). ``devices``
    is the device type (``"cuda"``, ``"cpu"``) or a device; by default the
    world's. Inside :func:`fake_world` the mesh's rank table is made with
    the fake mode set aside: it is data."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.device_mesh import init_device_mesh
    with unset_fake_temporarily():
        return init_device_mesh(_device_type(devices), tuple(shape),
                                mesh_dim_names=tuple(axes))


_mk = compat_make_mesh


def make_production_mesh(*, multi_pod: bool = False, devices=None):
    """(16, 16) over ("data", "model"), or (2, 16, 16) with "pod" in
    front: a world of 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk(shape, axes, devices)


def make_test_mesh(devices=None, model: int = 2):
    """A small (n // model, model) mesh over the running world of n ranks
    (``model`` capped at n)."""
    import torch.distributed as dist
    n = dist.get_world_size()
    model = min(model, n)
    return _mk((n // model, model), ("data", "model"), devices)


def make_host_mesh(device=None):
    """The 1×1 ("data", "model") mesh over one device: the card unless
    ``device`` says otherwise (raising without CUDA, as every entry point
    of the port). With no process group running, this starts a world of
    one (NCCL on the card, gloo on the CPU) on an in-process store; an
    existing world must be of size 1."""
    import torch.distributed as dist

    from repro_torch import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1,
                                device_id=dev if dev.type == "cuda" else None)
    return _mk((1, 1), ("data", "model"), dev.type)


@contextlib.contextmanager
def fake_world(n: int):
    """Rank 0 of a world of ``n`` ranks on the ``"fake"`` backend, inside a
    ``FakeTensorMode``: a mesh of any size builds, DTensor's collectives
    are recorded but move nothing, and no tensor made inside holds data.
    DTensor's sharding propagation runs with the fake mode set aside
    (``analysis.torch_trace.sharding_propagation_apart``). The process
    group is destroyed on exit."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.analysis.torch_trace import sharding_propagation_apart
    if dist.is_initialized():
        raise RuntimeError("fake_world needs a process without a default "
                           "process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        with sharding_propagation_apart(), \
                FakeTensorMode(allow_non_fake_inputs=True) as mode:
            yield mode
    finally:
        dist.destroy_process_group()
