"""SLAM entry point of the port (counterpart of
`dqo_map_tpu/cli/run_slam.py`).

    python -m dqo_map_tpu_torch.cli.run_slam --config configs/synthetic/room.yaml \
        [--device cuda] [--max-frames N] [--eval-every N] [--quiet] \
        [--resume <checkpoint>] [--checkpoint-every N]

Writes the merged config, the run's outputs (`SLAMSystem.run`) and
`result.json` (the final metrics, ATE and performance numbers) under the
config's `save_path`.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="DQO-MAP SLAM (PyTorch)")
    parser.add_argument("--config", type=str,
                        default="configs/synthetic/room.yaml")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the whole run (cuda or cpu)")
    parser.add_argument("--max-frames", type=int, default=-1)
    parser.add_argument("--eval-every", type=int, default=0)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--resume", type=str, default=None,
                        help="checkpoint path (without .npz) to resume from")
    parser.add_argument("--checkpoint-every", type=int, default=0)
    args = parser.parse_args(argv)

    from ..config import Config
    from ..slam.system import SLAMSystem

    cfg = Config.from_yaml(args.config)
    os.makedirs(cfg.map.save_path, exist_ok=True)
    cfg.dump(os.path.join(cfg.map.save_path, "config.yaml"))

    system = SLAMSystem(cfg, device=args.device)
    start = system.resume(args.resume) if args.resume else 0
    result = system.run(eval_every=args.eval_every or cfg.map.save_step,
                        verbose=not args.quiet, max_frames=args.max_frames,
                        start_frame=start,
                        checkpoint_every=args.checkpoint_every)
    scalars = {k: v for k, v in result.items()
               if isinstance(v, (int, float, str, type(None)))}
    print(json.dumps(scalars, indent=2))
    with open(os.path.join(cfg.map.save_path, "result.json"), "w") as f:
        json.dump(scalars, f, indent=2)
    return scalars


if __name__ == "__main__":
    main()
