"""Train the dense decoder from fresh weights in both packages, on the CPU.

    JAX_PLATFORMS=cpu python tests/dense_lr_probe.py --steps 20 --n-points 512
    JAX_PLATFORMS=cpu python tests/dense_lr_probe.py --tiny --steps 20

Runs ``gaus_10cm.yaml``'s dense decoder (the YAML's widths, or the CLI's
``--tiny`` ones) through ``train_dense_decoder``'s step at the YAML's lr
(``--lr`` to change it): clip 1.0, AdamW with the YAML's weight decay, one
synthetic cloud a step, the same clouds for every arm. The arms:

- ``jax``: the JAX package, from ``model.init`` under seed 0;
- ``port_default``: the port, from torch's initialisers under seed 0;
- ``port_jaxw``: the port, from the ``jax`` arm's initial weights.

Each step prints the loss, the share of pixels whose alpha exceeds 1e-3 and
the share of valid surfels with a positive opacity; a decoder whose every
surfel is transparent reads 0 and 0 and gets no gradient back. At full
width JAX's backward over the chunk loop keeps every chunk, about 8 GiB at
1024 points: keep ``--n-points`` at 512 or less.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

YAML = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                    "ours", "nuscenes", "dense_decoder", "gaus_10cm.yaml")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--n-points", type=int, default=512)
    p.add_argument("--lr", type=float, default=None, help="default: the YAML's")
    p.add_argument("--arms", default="jax,port_default,port_jaxw")
    p.add_argument("--threads", type=int, default=4)
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    import torch

    from lidar_layout_tpu.config import instantiate_from_config as j_instantiate
    from lidar_layout_tpu.config import load_yaml
    from lidar_layout_tpu.data.factory import build_batches
    from lidar_layout_tpu.models.gs_decoder import gs_loss, render_surfels
    from lidar_layout_tpu.ops.gaussian_raster import RasterConfig
    from lidar_layout_tpu.ops.lidar import LidarGeometry, pcd2range
    from lidar_layout_tpu_torch.config import instantiate_from_config
    from lidar_layout_tpu_torch.models import gs_decoder as PG
    from lidar_layout_tpu_torch.ops.gaussian_raster import RasterConfig as PRasterConfig
    from lidar_layout_tpu_torch.ops.lidar import LidarGeometry as PGeometry
    from lidar_layout_tpu_torch.train import train_dense_decoder as TD
    from lidar_layout_tpu_torch.utils.convert import dense_tree_state_dict

    torch.set_num_threads(args.threads)
    arms = args.arms.split(",")
    cfg = load_yaml(YAML)
    lr = cfg["optimizer"]["lr"] if args.lr is None else args.lr
    wd = cfg["optimizer"]["weight_decay"]

    def model_cfg():
        mc = load_yaml(YAML)["model"]
        if args.tiny:
            mc["params"]["backbone"]["params"].update(TD.TINY_BACKBONE)
            mc["params"]["head"] = {"params": {"feat_dim": 16}}
        return mc

    if args.tiny:
        geo = dict(size=(16, 64), fov=(10, -30))
    else:
        geo = dict(size=(32, 1024), fov=(10, -30), depth_range=(1.0, 56.0), depth_scale=5.84,
                   log_scale=True)
    geom, pgeom = LidarGeometry(**geo), PGeometry(**geo)
    chunk = 128 if args.tiny else 512
    print(f"dense decoder ({'tiny' if args.tiny else 'the YAML widths'}, {args.n_points} points, "
          f"{geo['size']}, chunk {chunk}) at lr {lr:g}, weight decay {wd:g}, {args.steps} steps")

    raw = build_batches("nusc_cube_decode", {"max_points": args.n_points}, {}, None, 1, seed=0,
                        force_synthetic=True)
    samples = []
    for _ in range(args.steps):
        b = next(raw)
        pts, feats, mask = (jnp.asarray(b[k][0]) for k in ("points", "feats", "mask"))
        gt, _ = pcd2range(pts, geom, mask=mask)
        samples.append({"points": pts, "feats": feats, "mask": mask,
                        "gt_range": jnp.where(gt > 0, gt, 0.0), "gt_mask": gt > 0})

    def shares(alpha, opacities, mask):
        a, o, m = np.asarray(alpha), np.asarray(opacities), np.asarray(mask)
        return float((a > 1e-3).mean()), float((o[m] > 0).mean())

    j_model = j_instantiate(model_cfg())
    s0 = samples[0]
    j_params0 = j_model.init(jax.random.key(0), s0["points"], s0["feats"], s0["mask"])
    curves = {}
    if "jax" in arms:
        tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(lr, weight_decay=wd))

        @jax.jit
        def step(params, opt, b):
            def loss_fn(p_):
                s = j_model.apply(p_, b["points"], b["feats"], b["mask"])
                r = render_surfels(s, geom, RasterConfig(chunk=chunk))
                loss, _ = gs_loss(r, b["gt_range"], b["gt_mask"])
                return loss, (r["alpha"], s["opacities"], s["mask"])
            (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            upd, opt = tx.update(grads, opt, params)
            return optax.apply_updates(params, upd), opt, loss, aux

        params, opt = j_params0, tx.init(j_params0)
        curves["jax"] = []
        for b in samples:
            params, opt, loss, aux = step(params, opt, b)
            curves["jax"].append((float(loss), *shares(*aux)))

    for arm in (a for a in arms if a.startswith("port_")):
        torch.manual_seed(0)
        model = instantiate_from_config(model_cfg(), in_features=4)
        if arm == "port_jaxw":
            model.load_state_dict(dense_tree_state_dict(jax.tree.map(np.asarray, j_params0)))
        elif arm != "port_default":
            raise SystemExit(f"unknown arm {arm}")
        state = TD.create_dense_state(model, lr, wd)
        params = list(model.parameters())
        curves[arm] = []
        for b in samples:
            t = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
            s = model(t["points"], t["feats"], t["mask"])
            r = PG.render_surfels(s, pgeom, PRasterConfig(chunk=chunk))
            loss, _ = PG.gs_loss(r, t["gt_range"], t["gt_mask"])
            state.optimizer.step(list(torch.autograd.grad(loss, params)))
            curves[arm].append((float(loss.detach()),
                                *shares(r["alpha"].detach(), s["opacities"].detach(),
                                        s["mask"])))

    for arm, rows in curves.items():
        print(arm)
        for i, (loss, pix, surf) in enumerate(rows):
            extra = ""
            if arm == "port_jaxw" and "jax" in curves:
                extra = f"  loss relative to jax {abs(loss / curves['jax'][i][0] - 1):.2e}"
            print(f"  step {i:3d} loss {loss:.5f} pixels alpha>1e-3 {pix:.4f} "
                  f"surfels opacity>0 {surf:.4f}{extra}")


if __name__ == "__main__":
    main()
