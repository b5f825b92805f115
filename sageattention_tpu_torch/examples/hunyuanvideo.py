"""hunyuanvideo with sage attention (reference: example/hunyuanvideo.py).

Runs the port's hunyuanvideo-shaped video DiT (DualStreamVideoDiT) with the selected
attention backend and reports per-denoise-step time and output parity.
Use --scale 1.0 for the full model geometry.

    python -m sageattention_tpu_torch.examples.hunyuanvideo --scale 1.0 --steps 2 --compare
"""

from sageattention_tpu_torch import models
from sageattention_tpu_torch.examples.common import base_parser, run_video_example


def main(argv=None, **kw) -> dict:
    """Parse ``argv`` and run; ``kw`` goes to ``run_video_example`` (``cfg``,
    ``state_dict``, ``inputs``)."""
    args = base_parser(__doc__.split("\n\n")[0]).parse_args(argv)
    return run_video_example("hunyuanvideo", args, models.DualStreamVideoDiT, **kw)


if __name__ == "__main__":
    main()
