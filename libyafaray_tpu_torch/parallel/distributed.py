"""Multi-process entry point: the render farm on `torch.distributed`.

Counterpart of `libyafaray_tpu/parallel/distributed.py`, the reference's
render farm (SURVEY.md section 2.15): N processes each render with a
decorrelated sample stream and their films are summed
(imageFilmLoadAllInFolder, src/render/imagefilm.cc:940-1008).

  - `init_distributed()` initializes torch's default process group, so that
    `parallel.make_mesh` spans every process and the films can be merged by
    `film.psum_merge` over the mesh;
  - `render_node_film()` renders this process's decorrelated share (the
    film's computer node sets its sampling offset, the reference's
    adv_base_sampling_offset, src/scene/scene.cc:608-609) and saves a film
    checkpoint that any process can later merge with
    `film.load_all_in_folder`: sums, so the order does not matter.

Importing this module initializes neither CUDA nor a process group.

    torchrun --nproc-per-node=2 my_farm.py      # each process calls:
    rank, world = init_distributed()
    render_node_film(scene, cfg, w, h, spp, node=rank, out_dir="films")
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .. import film as F
from ..render import render


def local_rank(rank: int) -> int:
    """The rank of process `rank` on its host: torchrun's LOCAL_RANK, else
    `rank` (one process per device on one host)."""
    return int(os.environ.get("LOCAL_RANK", rank))


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *, device="cuda",
                     backend: Optional[str] = None) -> Tuple[int, int]:
    """Initialize the default process group; returns (rank, world size).

    With no arguments it reads torch's standard variables, as torchrun sets
    them: MASTER_ADDR and MASTER_PORT (the coordinator), WORLD_SIZE, RANK
    and LOCAL_RANK. `coordinator_address` is "host:port" (or a tcp:// URL).
    On `device` "cuda" the process's device becomes `cuda:<local rank>`
    before any CUDA call (a device with an index, such as "cuda:0" for
    ranks that share one card, is taken as it is). The backend is the
    caller's: by default "nccl" on a CUDA device and "gloo" on the CPU;
    ranks that share one card name "gloo" (NCCL refuses them)."""
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if coordinator_address is None:
        raise ValueError("init_distributed: no coordinator address (pass "
                         "one, or set MASTER_ADDR and MASTER_PORT)")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else local_rank(process_id))
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def render_node_film(scene, cfg, width: int, height: int, spp: int,
                     node: int, out_dir: Optional[str] = None,
                     layer_names=("combined",), *, device="cuda"):
    """Render this node's decorrelated share of the image on `device` (the
    card unless the caller names another) and, with `out_dir`, checkpoint
    it there as node<NNNN>.film.npz for the folder merge. The per-node
    sampling offset gives each node its own sample stream for the same
    pixels, so the merged film is a render at the nodes' total spp."""
    film = F.make_film(width, height, layer_names, computer_node=node,
                       device=device)
    film = render(scene, cfg, width, height, spp=spp, film=film,
                  device=device)
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        F.save_film(film, os.path.join(out_dir, f"node{node:04d}.film.npz"),
                    sampling_offset=film.base_sampling_offset + spp)
    return film
