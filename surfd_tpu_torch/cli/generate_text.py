"""Text-conditional generation CLI: the prompt is encoded once by CLIP's
text tower (512-d) and fed to the denoiser as context, with classifier-free
guidance (`--guidance_param`) as one batched pass of the context and zeros;
latent 64 (the text2shape AE) by default; --watertight drops components
under 5000 faces. On CUDA by default:

  python -m surfd_tpu_torch.cli.generate_text --ae_dir ... --model_path model.pt \\
      --clip_npz clip.npz --text_prompt "a long dress" --guidance_param 2.5
"""

import torch

from ._common import cli_context, context_parser, run_generation


def encode_text_clip(prompts, clip_npz: str, device) -> torch.Tensor:
    """(len(prompts), 512) CLIP text embeddings on `device`."""
    from ..models.clip import tokenize
    from ..utils.convert import load_clip_params

    model = load_clip_params(clip_npz).to(device)
    with torch.no_grad():
        return model.encode_text(torch.from_numpy(tokenize(prompts)).to(device))


def main(argv=None):
    ap = context_parser(__doc__)
    ap.add_argument("--text_prompt", required=True)
    ap.set_defaults(latent_size=64, min_component_faces=5000)
    args = ap.parse_args(argv)
    context = cli_context(args, lambda dev: encode_text_clip([args.text_prompt], args.clip_npz, dev))
    return run_generation(args, cond_mode="text", context=context, tag="text", argv=argv)


if __name__ == "__main__":
    main()
