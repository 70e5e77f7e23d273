"""Category-conditional generation CLI: one garment class for every sample,
fed to the denoiser's label embedding, with classifier-free guidance
(`--guidance_param`) as one batched pass of the class and the null class.
On CUDA by default:

  python -m surfd_tpu_torch.cli.generate_cat --ae_dir ... --model_path model.pt \\
      --category long-skirt --guidance_param 2.5 --sampler ddim --timestep_respacing ddim50
"""

import torch

from ._common import base_parser, run_generation

# The nine garment classes, in class-id order.
GARMENT_CLASSES = (
    "dress", "jumpsuit", "long-pants", "long-shirt", "long-skirt",
    "short-pants", "short-shirt", "short-skirt", "tank-top",
)


def main(argv=None):
    ap = base_parser(__doc__)
    ap.add_argument("--category", type=str, default="dress",
                    help=f"one of {GARMENT_CLASSES} or an integer id")
    ap.add_argument("--category_list", default="",
                    help="garment_type_list.txt-format class map; replaces the built-in "
                    "classes (and sets --num_actions when that is 0)")
    args = ap.parse_args(argv)
    classes = GARMENT_CLASSES
    if args.category_list:
        from ..data import load_garment_categories

        _, cat2name = load_garment_categories(args.category_list)
        classes = tuple(cat2name[i] for i in sorted(cat2name))
        if not args.num_actions:
            args.num_actions = len(classes)
    if args.category.isdigit():
        cat = int(args.category)
    elif args.category in classes:
        cat = classes.index(args.category)
    else:
        ap.error(f"--category {args.category!r} is neither an id nor one of {classes}")
    from ..utils.device import resolve_device

    action = torch.full((args.num_samples,), cat, dtype=torch.int64,
                        device=resolve_device(args.device))
    return run_generation(args, cond_mode="category", action=action, tag=f"cat{cat}", argv=argv)


if __name__ == "__main__":
    main()
