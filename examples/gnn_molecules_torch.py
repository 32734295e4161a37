"""Train the NequIP E(3)-equivariant potential on batched synthetic
molecules (the `molecule` cell at laptop scale) on the PyTorch port, and
check that the trained energy is rotation-invariant (the loop of
``examples/gnn_molecules.py``).

    # on the card: every message sum through the gather-segment-sum kernel
    PYTHONPATH=src python examples/gnn_molecules_torch.py
    # on the CPU (the kernel's plain version), a few steps
    PYTHONPATH=src python examples/gnn_molecules_torch.py --device cpu --steps 3
"""
import argparse

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.gnn import (GraphBatch, NequipConfig, irreps,
                                    nequip_forward, nequip_init, nequip_loss)
from repro_torch.optim import AdamWConfig, init_state
from repro_torch.train import make_train_step


def make_molecules(step, n_mol=16, atoms=8, seed=0, device="cpu"):
    """``n_mol`` molecules of ``atoms`` atoms, every ordered pair an
    edge, and a pair-potential energy target (invariant by
    construction); the numpy draws of the JAX example."""
    rng = np.random.default_rng((seed, step))
    n = n_mol * atoms
    pos = rng.standard_normal((n, 3)) * 1.5
    gid = np.repeat(np.arange(n_mol), atoms)
    src, dst = [], []
    for m in range(n_mol):
        ii = np.arange(m * atoms, (m + 1) * atoms)
        a, b = np.meshgrid(ii, ii)
        keep = a != b
        src.append(a[keep])
        dst.append(b[keep])
    src = np.concatenate(src)
    dst = np.concatenate(dst)
    z = rng.integers(0, 4, n)
    d = np.linalg.norm(pos[src] - pos[dst], axis=1)
    y = np.zeros(n_mol)
    np.add.at(y, gid[src], 0.5 * np.exp(-d))

    def put(a, dtype):
        return torch.from_numpy(np.asarray(a, dtype)).to(device)

    return GraphBatch(
        x=torch.zeros((n, 1), device=device), z=put(z, np.int32),
        pos=put(pos, np.float32), src=put(src, np.int32),
        dst=put(dst, np.int32),
        edge_mask=torch.ones(len(src), device=device),
        node_mask=torch.ones(n, device=device),
        labels=torch.zeros(n, dtype=torch.int32, device=device),
        graph_id=put(gid, np.int32), y=put(y, np.float32), n_graphs=n_mol)


def rotated(batch: GraphBatch, rot: np.ndarray) -> GraphBatch:
    fields = batch.tensors()
    fields["pos"] = batch.pos @ torch.as_tensor(rot.T, dtype=torch.float32,
                                                device=batch.pos.device)
    return GraphBatch(**fields, n_graphs=batch.n_graphs)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = NequipConfig(n_layers=2, d_hidden=16)
    params = nequip_init(torch.Generator().manual_seed(0), cfg, device=dev)
    step_fn = make_train_step(lambda p, b: nequip_loss(p, b, cfg),
                              AdamWConfig(lr=3e-3, weight_decay=0.0))
    state = init_state(params)
    losses = []
    for step in range(args.steps):
        params, state, m = step_fn(params, state,
                                   make_molecules(step, device=dev))
        losses.append(float(m["loss"]))
        if step % 15 == 0:
            print(f"step {step:3d} loss {losses[-1]:.4f}")
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise SystemExit(f"training did not lower the loss: {losses}")

    # rotation invariance of the trained energy
    b = make_molecules(999, device=dev)
    rot = irreps.random_rotation(3)
    with torch.no_grad():
        _, e1 = nequip_forward(params, b, cfg)
        _, e2 = nequip_forward(params, rotated(b, rot), cfg)
    err = float((e1 - e2).abs().max())
    print(f"rotation-invariance error of trained model: {err:.2e}")
    if not err < 1e-3:
        raise SystemExit(f"energy not rotation-invariant: {err}")
    print("OK")
    return {"losses": losses, "rotation_err": err}


if __name__ == "__main__":
    main()
