"""Image-conditional generation CLI: the image, composited on white inside
its mask and cropped square around it, goes through CLIP's preprocessing and
image tower, and the embedding is the denoiser's context, with
classifier-free guidance (`--guidance_param`); latent 64 (the pix3d AE) by
default. On CUDA by default:

  python -m surfd_tpu_torch.cli.generate_image --ae_dir ... --model_path model.pt \\
      --clip_npz clip.npz --image_path chair.png --mask_path chair_mask.png
"""

from typing import Optional

import numpy as np
import torch

from ..data.conditioning import clip_preprocess, composite_on_white, crop_square, mask2bbox
from ._common import cli_context, context_parser, read_mask, read_rgb, run_generation


def clip_input(img: np.ndarray, mask: Optional[np.ndarray] = None) -> np.ndarray:
    """uint8 (H, W, 3) image and optional bool (H, W) mask → the normalised
    (224, 224, 3) input of the image tower: with a mask, the image on white
    outside it, cropped square around its box."""
    if mask is not None:
        img = crop_square(composite_on_white(img, mask), mask2bbox(mask))
    return clip_preprocess(img)


def image_context(img: np.ndarray, mask: Optional[np.ndarray], clip, device) -> torch.Tensor:
    """(1, 512) image embedding on `device` of one image and mask, by `clip`
    (a Clip module on `device`)."""
    x = torch.from_numpy(clip_input(img, mask)[None]).to(device)
    with torch.no_grad():
        return clip.encode_image(x)


def main(argv=None):
    from ..utils.convert import load_clip_params

    ap = context_parser(__doc__)
    ap.add_argument("--image_path", required=True)
    ap.add_argument("--mask_path", default="")
    ap.set_defaults(latent_size=64)
    args = ap.parse_args(argv)

    def encode(device):
        mask = read_mask(args.mask_path) if args.mask_path else None
        return image_context(read_rgb(args.image_path), mask,
                             load_clip_params(args.clip_npz).to(device), device)

    context = cli_context(args, encode)
    return run_generation(args, cond_mode="img", context=context, tag="img", argv=argv)


if __name__ == "__main__":
    main()
