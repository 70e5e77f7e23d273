"""Unconditional generation CLI (latent 32, decoder 512/5, DDPM 1000 steps
by default, mesh extraction + cleanup), on CUDA by default:

  python -m surfd_tpu_torch.cli.generate_uncond --ae_dir ... --model_path model.pt \\
      --num_samples 2 --resolution 256
"""

from ._common import base_parser, run_generation


def main(argv=None):
    args = base_parser(__doc__).parse_args(argv)
    return run_generation(args, cond_mode="no_cond", tag="uncond", argv=argv)


if __name__ == "__main__":
    main()
