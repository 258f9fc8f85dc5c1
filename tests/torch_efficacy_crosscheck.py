"""The efficacy twin's trained models through both packages on the CPU: the
classifier and NVAE files that `gen_adversarial_tpu_torch.efficacy_run`
wrote (stages 1-2), its adversarial set (stage 3), and the EoT-8 accuracy
of the purification defense on that set at given alpha schedules, computed
by the JAX package's `AlphaEvaluator` (the defense of tools/efficacy_run.py)
and by the port's. Both evaluate the same function with their own draws,
so they agree within the draws' spread where the port computes the JAX
defense; a gap between a run on the card and the JAX tool's own run is
then the trained models', not the port's arithmetic.

    python -m tests.torch_efficacy_crosscheck <dir with classifier.msgpack,
        nvae_final.msgpack and adv_set/> [alphas as a,b,c,d ...]

Prints one JSON line: for each schedule, both packages' accuracy.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
# the JAX tool's best schedule on its own trained models (EFFICACY_r05.json)
JAX_BEST = "1.0,1.0,0.0,0.722"


def main(argv):
    work = Path(argv[0])
    schedules = [np.array([float(a) for a in s.split(",")], np.float32)
                 for s in (argv[1:] or [JAX_BEST])]

    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch

    spec = importlib.util.spec_from_file_location("jax_efficacy_run",
                                                  REPO / "tools" / "efficacy_run.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    from gen_adversarial_tpu.core.checkpoint import load_variables
    from gen_adversarial_tpu.models.classifiers import VGG11BN as JaxVGG
    from gen_adversarial_tpu.models.nvae.model import NVAE as JaxNVAE
    from gen_adversarial_tpu.models.nvae.model import NVAEConfig as JaxNVAEConfig
    from gen_adversarial_tpu.search.alphas import AlphaEvaluator as JaxEvaluator
    import gen_adversarial_tpu_torch.efficacy_run as er
    from gen_adversarial_tpu_torch.core.convert import from_jax_variables
    from gen_adversarial_tpu_torch.data.datasets import ImageLabelDataset
    from gen_adversarial_tpu_torch.models.classifiers import VGG11BN
    from gen_adversarial_tpu_torch.models.nvae.model import NVAE, NVAEConfig
    from gen_adversarial_tpu_torch.search.alphas import AlphaEvaluator

    clf_vars, clf_meta = load_variables(work / "classifier.msgpack")
    nvae_vars, meta = load_variables(work / "nvae_final.msgpack")
    plan = tuple(clf_meta["plan"])
    n_classes = len(clf_vars["params"]["classifier"]["fc1"]["bias"])
    size = meta["config"]["resolution"]
    adv = ImageLabelDataset(str(work / "adv_set"), size)
    images = np.stack([adv.load_image(i) for i in range(len(adv))])
    cpu = torch.device("cpu")
    clf = from_jax_variables(clf_vars, VGG11BN(n_classes, plan=plan, device=cpu))
    nvae = from_jax_variables(nvae_vars, NVAE(NVAEConfig(**meta["config"]), device=cpu))
    port = er._make_defense(nvae, clf, np.zeros(nvae.cfg.n_latents), cpu)
    jax_nvae = JaxNVAE(JaxNVAEConfig(**meta["config"]))
    tool.IMAGE_SIZE = size
    out = []
    for alphas in schedules:
        jdef = tool._make_defense(jax_nvae, nvae_vars, JaxVGG(n_classes, plan=plan), clf_vars,
                                  np.zeros(len(alphas)))
        want = JaxEvaluator(jdef, images, adv.labels, attenuation=1.0,
                            eot_steps=er.EOT_STEPS, batch_size=er.EVAL_BATCH,
                            seed=er.SEED).objective_function(alphas)
        with torch.no_grad():
            got = AlphaEvaluator(port, images, adv.labels, attenuation=1.0,
                                 eot_steps=er.EOT_STEPS, batch_size=er.EVAL_BATCH,
                                 seed=er.SEED, device=cpu).objective_function(alphas)
        out.append({"alphas": alphas.round(4).tolist(), "jax_acc": float(want),
                    "port_acc": float(got)})
    print(json.dumps({"n_adv": len(adv), "recon": {k: meta.get(k) for k in
                                                  ("recon_acc", "recon_l2")},
                      "schedules": out}))


if __name__ == "__main__":
    main(sys.argv[1:])
