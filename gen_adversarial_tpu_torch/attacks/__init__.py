"""Batched untargeted L2 attacks (counterpart of gen_adversarial_tpu/attacks).

Every attack is attack(net, images, labels, generator, **hyperparameters)
-> (success (B,) bool, bound (B,) float32, adv (B, H, W, C)), with images
NHWC in [0, 1] on any device; the attack runs on theirs. `net(x, draws)`
gives logits: the EoT net of defenses/eot.py, or any deterministic
callable. `generator` is a `torch.Generator` or a `Draws` source
(models/nvae/distributions.py): every call of `net` gets it and so draws
afresh, and the attack's own draws (APGD's start, C&W's restart noise) come
from it too, so tests can replay recorded noise. A loop that ends early
reads one boolean from the device per step; nothing else goes to the host.
"""

from gen_adversarial_tpu_torch.attacks.apgd import apgd_attack
from gen_adversarial_tpu_torch.attacks.autoattack import autoattack, make_staged_autoattack
from gen_adversarial_tpu_torch.attacks.cw import cw_attack
from gen_adversarial_tpu_torch.attacks.deepfool import deepfool_attack
from gen_adversarial_tpu_torch.attacks.fab import fab_attack
from gen_adversarial_tpu_torch.attacks.fgsm import fgsm_attack
from gen_adversarial_tpu_torch.attacks.utils import (
    class_grads, l2_norm, normalize, projection_l2)

__all__ = ["apgd_attack", "autoattack", "class_grads", "cw_attack", "deepfool_attack",
           "fab_attack", "fgsm_attack", "l2_norm", "make_staged_autoattack", "normalize",
           "projection_l2"]
