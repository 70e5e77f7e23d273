"""Sketch-conditional generation CLI: the sketch PNG goes through CLIP's
preprocessing and image tower, and the embedding is the denoiser's context,
with classifier-free guidance (`--guidance_param`). On CUDA by default:

  python -m surfd_tpu_torch.cli.generate_sketch --ae_dir ... --model_path model.pt \\
      --clip_npz clip.npz --sketch_path sketch_0.png --guidance_param 2.5
"""

import numpy as np
import torch

from ._common import cli_context, context_parser, read_rgb, run_generation


def encode_image_clip(image_paths, clip_npz: str, device) -> torch.Tensor:
    """(len(image_paths), 512) CLIP image embeddings on `device`."""
    from ..data.conditioning import clip_preprocess
    from ..utils.convert import load_clip_params

    model = load_clip_params(clip_npz).to(device)
    batch = np.stack([clip_preprocess(read_rgb(p)) for p in image_paths])
    with torch.no_grad():
        return model.encode_image(torch.from_numpy(batch).to(device))


def main(argv=None):
    ap = context_parser(__doc__)
    ap.add_argument("--sketch_path", required=True)
    args = ap.parse_args(argv)
    context = cli_context(args, lambda dev: encode_image_clip([args.sketch_path], args.clip_npz, dev))
    return run_generation(args, cond_mode="sketch", context=context, tag="sketch", argv=argv)


if __name__ == "__main__":
    main()
