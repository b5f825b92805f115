"""cogvideox-2b with sage attention (reference: example/cogvideox-2b.py).

Runs the port's cogvideox-2b-shaped video DiT with the selected
attention backend and reports per-denoise-step time and output parity.
Use --scale 1.0 for the full model geometry.

    python -m sageattention_tpu_torch.examples.cogvideox_2b --scale 1.0 --steps 2 --compare
"""

from sageattention_tpu_torch.examples.common import base_parser, run_video_example


def main(argv=None, **kw) -> dict:
    """Parse ``argv`` and run; ``kw`` goes to ``run_video_example`` (``cfg``,
    ``state_dict``, ``inputs``)."""
    args = base_parser(__doc__.split("\n\n")[0]).parse_args(argv)
    return run_video_example("cogvideox-2b", args, **kw)


if __name__ == "__main__":
    main()
