"""Reference checkpoint converter (counterpart of tools/convert_checkpoints.py):
the paper's released PyTorch `.pt` files -> the flax msgpack files (and
their `<name>.json` meta) that both packages' `load_defense` read, on a
machine without JAX. torch only reads the file, on the CPU; the conversion
is numpy (core/*_convert.py) and the file is written by
core/checkpoint.save_variables. Each kind's file layout:

  classifier  {'state_dict': ...}                        -> --kind classifier
  NVAE        {'configuration', 'state_dict_temp=t'}     -> --kind nvae
  E4E         {'opts', 'latent_avg', 'state_dict'}       -> --kind e4e
  StyleTrans  {'opts', 'latent_avg', encoder.module.*}   -> --kind trans
  A-VAE       plain state dict (EMA g_running)           -> --kind avae
  ND-VAE      plain state dict                           -> --kind ndvae

  python -m gen_adversarial_tpu_torch.cli.convert_checkpoints --kind nvae \\
      --src ckpt.pt --dst checkpoints/nvae_ids.msgpack [--temperature 0.6]

The `.pt` is unpickled whole (its 'opts' are argparse Namespaces): convert
only files from a source you trust.
"""

from __future__ import annotations

import argparse
import dataclasses


def to_numpy_sd(sd: dict) -> dict:
    return {k: v.detach().numpy() if hasattr(v, "detach") else v for k, v in sd.items()}


def main(argv: list[str] | None = None) -> tuple:
    """Returns (variables, meta) as written to --dst."""
    p = argparse.ArgumentParser("reference checkpoint converter")
    p.add_argument("--kind", required=True,
                   choices=["classifier", "nvae", "e4e", "trans", "avae", "ndvae"])
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--model-type", default="resnet", choices=["resnet", "vgg", "resnext"],
                   help="classifier kind (for --kind classifier)")
    p.add_argument("--temperature", type=float, default=0.6,
                   help="NVAE per-temperature state dict selector")
    p.add_argument("--stylegan-size", type=int, default=1024)
    p.add_argument("--output-size", type=int, default=512)
    p.add_argument("--image-size", type=int, default=128,
                   help="A-VAE / ND-VAE input resolution")
    p.add_argument("--ndvae", nargs=6, type=int, default=None,
                   metavar=("XCH", "ENC", "PREGROUPS", "SCALES", "GROUPS", "CELLS"))
    args = p.parse_args(argv)
    if args.kind == "ndvae" and args.ndvae is None:
        p.error("--kind ndvae requires --ndvae XCH ENC PREGROUPS SCALES "
                "GROUPS CELLS (the Defence_NVAE architecture ints)")

    import torch

    from gen_adversarial_tpu_torch.core.checkpoint import save_variables

    ckpt = torch.load(args.src, map_location="cpu", weights_only=False)
    meta = {"kind": args.kind, "source": str(args.src)}

    if args.kind == "classifier":
        from gen_adversarial_tpu_torch.core.torch_convert import convert_classifier
        variables = convert_classifier(to_numpy_sd(ckpt["state_dict"]), args.model_type)
        meta["model_type"] = args.model_type
    elif args.kind == "nvae":
        from gen_adversarial_tpu_torch.core.torch_convert import convert_nvae
        from gen_adversarial_tpu_torch.models.nvae.model import NVAEConfig
        config = ckpt["configuration"]
        cfg = NVAEConfig.from_reference_dict(config["autoencoder"], config["resolution"])
        variables = convert_nvae(to_numpy_sd(ckpt[f"state_dict_temp={args.temperature}"]), cfg)
        meta["config"] = dataclasses.asdict(cfg)
    elif args.kind == "e4e":
        from gen_adversarial_tpu_torch.core.stylegan_convert import convert_psp
        sd = to_numpy_sd(ckpt["state_dict"])
        sd["latent_avg"] = ckpt["latent_avg"].numpy()
        variables = convert_psp(sd, args.stylegan_size)
        meta["stylegan_size"] = args.stylegan_size
    elif args.kind == "trans":
        from gen_adversarial_tpu_torch.core.stylegan_convert import convert_style_transformer
        sd = to_numpy_sd(ckpt["state_dict"])
        if "latent_avg" in ckpt:
            sd["latent_avg"] = ckpt["latent_avg"].numpy()
        variables = convert_style_transformer(sd, args.output_size)
        meta["output_size"] = args.output_size
    elif args.kind == "avae":
        from gen_adversarial_tpu_torch.core.avae_convert import convert_avae
        # the reference defense loads a bare g_running (EMA) state dict; a
        # 'train-iter-*.pt' resume dict holds the live generator instead
        if "generator" in ckpt:
            print("WARNING: this looks like an A-VAE train-iter resume "
                  "checkpoint; converting its LIVE 'generator' weights, not "
                  "the EMA g_running the reference defense loads (the EMA "
                  "weights are the bare-state-dict NNNNNN.pt files)")
            sd = to_numpy_sd(ckpt["generator"])
        else:
            sd = to_numpy_sd(ckpt)
        variables = convert_avae(sd, args.image_size)
        meta["image_size"] = args.image_size
    else:  # ndvae
        from gen_adversarial_tpu_torch.core.ndvae_convert import NDVAEArch, convert_ndvae
        variables = convert_ndvae(to_numpy_sd(ckpt), NDVAEArch(*args.ndvae, args.image_size))
        meta["ndvae"] = args.ndvae

    save_variables(args.dst, variables, meta)
    print(f"converted {args.src} -> {args.dst}")
    return variables, meta


if __name__ == "__main__":
    main()
