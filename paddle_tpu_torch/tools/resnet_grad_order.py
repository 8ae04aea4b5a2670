"""How far a ResNet-50 gradient at init moves when only the order of its
batch sums changes: the gradient of one batch (224 x 224, B = 128,
``fuse_bn``, seeded weights) against the gradient of the same batch with
its rows permuted, in bf16 and in f32, on the card.  The relative L2
distance by leaf (median, largest) is the yardstick for the data-parallel
gradient's distance from the one-rank gradient in ``chip_smoke.py``
phase 51, which reassociates the same sums.

    python -m paddle_tpu_torch.tools.resnet_grad_order
"""

import json

import torch

from .._tree import tree_leaves, tree_map
from ..models import resnet
from ..parallel.rules import leaf_paths
from ..parallel.train import grads_of


def grad_order(dtype, batch=128, image=224, seed=0):
    cfg = resnet.resnet50_config(dtype=dtype, fuse_bn=True, sync_bn=True,
                                 image_size=image)
    tr = resnet.build_resnet_trainer(cfg, seed=seed)
    b = resnet.synthetic_batches(cfg, 1, batch)[0]
    img = torch.from_numpy(b["image"]).to(tr.device, getattr(torch, dtype))
    lab = torch.from_numpy(b["label"]).to(tr.device)
    perm = torch.randperm(batch, generator=torch.Generator().manual_seed(1))
    loss_fn = resnet.make_loss_fn(cfg)

    def grad(images, labels):
        (loss, _), g = grads_of(
            lambda p, bb: loss_fn({"params": p, "_bn": tr.bn_state}, bb),
            tree_map(lambda t: t.clone(), tr.state["params"]),
            {"image": images, "label": labels})
        return float(loss.detach()), tree_leaves(g)

    l1, g1 = grad(img, lab)
    l2, g2 = grad(img[perm.to(img.device)], lab[perm.to(lab.device)])
    rel = sorted((float((a.double() - c.double()).norm() / c.double().norm()), n)
                 for a, c, n in zip(g2, g1, leaf_paths(tr.state["params"])[0]))
    return {"dtype": dtype, "loss": l1, "loss_permuted": l2,
            "grad_rel_l2_median": rel[len(rel) // 2][0],
            "grad_rel_l2_max": rel[-1][0], "grad_rel_l2_max_leaf": rel[-1][1]}


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    for dtype in ("bfloat16", "float32"):
        print(json.dumps(grad_order(dtype)), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
