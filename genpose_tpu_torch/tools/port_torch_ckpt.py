"""Convert a released GenPose torch checkpoint (.pth) into a genpose_tpu_torch checkpoint.

The reference releases ``ckpt_epoch{N}.pth`` files written by
``networks/posenet_agent.py:117-141`` (a dict with the ``model_state_dict``
of the full ``GFObjectPose``).  This tool maps every weight onto the port's
model (``genpose_tpu_torch/utils/torch_port.py``) and writes
``<output>/ckpt_epoch{N}`` + ``clock.json``, which the port loads as it
is: ``InferencePipeline(cfg, score_ckpt=..., energy_ckpt=...)``, and
``runners/evaluation_single.py`` / ``runners/evaluation_tracking.py`` with
``--score_model_dir`` / ``--energy_model_dir`` naming the output under
``results/ckpts``.  Needs no JAX and no card.

Usage (the flags of ``tools/port_torch_ckpt.py``):
    python -m genpose_tpu_torch.tools.port_torch_ckpt \\
        --input  scorenet.pth \\
        --output results/ckpts/ported_score \\
        --posenet_mode score \\
        [--pts_encoder pointnet2 --regression_head Rx_Ry_and_T \\
         --pose_mode rot_matrix --sde_mode ve --num_points 1024]

``--sde_mode edm`` with ``--posenet_mode score`` reads an EDM decoder head.
"""

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input", required=True, help=".pth checkpoint to read")
    p.add_argument("--output", required=True, help="checkpoint directory to write")
    p.add_argument("--posenet_mode", default="score", choices=["score", "energy"])
    p.add_argument("--pts_encoder", default="pointnet2")
    p.add_argument("--regression_head", default="Rx_Ry_and_T")
    p.add_argument("--pose_mode", default="rot_matrix")
    p.add_argument("--sde_mode", default="ve")
    p.add_argument("--num_points", type=int, default=1024)
    p.add_argument("--epoch", type=int, default=None,
                   help="epoch tag for the output (default: from the clock)")
    args = p.parse_args(argv)

    from genpose_tpu_torch.config import Config
    from genpose_tpu_torch.utils.torch_port import port_checkpoint_file

    cfg = Config(posenet_mode=args.posenet_mode, pts_encoder=args.pts_encoder,
                 regression_head=args.regression_head, pose_mode=args.pose_mode,
                 sde_mode=args.sde_mode, num_points=args.num_points)
    path = port_checkpoint_file(args.input, args.output, cfg, posenet_mode=args.posenet_mode,
                                epoch=args.epoch)
    print(f"ported {args.input} -> {path}")
    return path


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
