"""One batch's gradients of the port's stage-2 loss against the JAX
package's, leaf by leaf (the method and bound of
tests/test_torch_stage1_grads.py): ivlp, promptsrc (with the SmoothL1
distillation to the frozen teacher) and adapter, fp32, through the plain
blocks and through the blocks' autograd Functions, with the same class text
features fed to both and a padded row in the batch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_reid_model import tiny_models
from tests.test_torch_stage1_grads import batch_arrays, compare_grads, grad_capture, port_grads
from tpu_reid.models import reid_clip as JM
from tpu_reid.train import optim as JO
from tpu_reid.train import trainer as JTR
from tpu_reid_torch.models import reid_clip as TM
from tpu_reid_torch.train import trainer as TTR


@pytest.fixture(scope="module", params=["ivlp", "promptsrc", "adapter"])
def stage2(request):
    mode = request.param
    jcfg, jp, tcfg, tp = tiny_models(mode)
    _, images, labels, valid = batch_arrays(3)
    text = np.array(JM.all_class_text_features(jp, jcfg))
    jt, jf = JO.partition(jp, lambda p: JM.stage2_trainable(p, jcfg))
    opt = grad_capture()
    step = JTR.make_stage2_step(jcfg, JTR.TrainConfig(), opt)
    _, _, jgrads, jloss = step(jt, jf, opt.init(jt), jnp.asarray(images), jnp.asarray(labels),
                               jnp.asarray(text), jnp.asarray(valid))
    return mode, tcfg, tp, (images, labels, text, valid), float(jloss), jgrads


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_stage2_gradients_match_jax(stage2, impl):
    mode, tcfg, tp, arrays, jloss, jgrads = stage2
    images, labels, text, valid = (torch.from_numpy(a) for a in arrays)
    loss, grads = port_grads(
        tp, lambda p: TM.stage2_trainable(p, tcfg),
        lambda params: TTR.stage2_loss(tcfg, TTR.TrainConfig(), params, images, labels, text,
                                       valid)[0], impl)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    compare_grads(grads, jgrads)
    assert len(grads) > 1
