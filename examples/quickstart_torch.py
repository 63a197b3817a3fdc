"""Quickstart on the PyTorch port: the Elim-ABtree as a dictionary,
elimination in action, durability, and a tiny LM loss — the program of
``quickstart.py`` over ``repro_torch``.

    PYTHONPATH=src python examples/quickstart_torch.py                # on the CUDA card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu   # plain versions on the host
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.core import ABTree, DurableABTree, OP_DELETE, OP_INSERT, TreeConfig, recover


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)
    device = args.device

    # --- 1. batched dictionary ------------------------------------------------
    tree = ABTree(TreeConfig(capacity=1024), mode="elim", device=device)
    tree.insert(42, 4200)
    print("find(42) →", tree.find(42))

    # --- 2. publishing elimination: 64 concurrent ops on ONE hot key ----------
    ops = [OP_INSERT, OP_DELETE] * 32
    keys = [7] * 64
    vals = list(range(64))
    tree.apply_round(ops, keys, vals)
    s = tree.stats()
    print(f"64 ops on one key → physical slot writes: {s['slot_writes'] - 2}, "
          f"eliminated: {s['eliminated']}")

    # --- 3. durability (link-and-persist) -------------------------------------
    with tempfile.TemporaryDirectory(prefix="elim_tree_") as d:
        dt = DurableABTree(d, TreeConfig(capacity=1024), device=device)
        dt.apply_round([OP_INSERT] * 3, [1, 2, 3], [10, 20, 30])
        dt.close()
        rec = recover(d, device=device)
        print("recovered contents:", rec.tree.items())
        rec.close()

    # --- 4. one LM loss (reduced qwen2) ---------------------------------------
    from repro_torch.configs import get_config
    from repro_torch.models import backbone, init_params, loss_fn, reduced

    cfg = reduced(get_config("qwen2-0.5b"), n_layers=2)
    params = init_params(backbone.model_spec(cfg), device)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (2, 32)), dtype=torch.int32,
                                       device=params["embed"]["tok"].device)}
    with torch.no_grad():
        loss, metrics = loss_fn(params, batch, cfg)
    print(f"qwen2(reduced) initial loss: {float(loss):.3f} "
          f"(≈ ln(vocab) = {np.log(cfg.vocab):.3f})")


if __name__ == "__main__":
    main()
