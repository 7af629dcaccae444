"""The port's train-state checkpoint (bigdl_tpu_torch/train/checkpoint.py),
the counterparts of test_train_recipes.py's checkpoint tests: a run
killed after step 3 of 6 and resumed into fresh objects reproduces the
uninterrupted losses exactly (QLoRA with AdamW, ReLoRA mid-phase with the
merged base, a GaLore full fine-tune with LISA's generator), templates of
another dtype are refused with nothing loaded, and the rotation skips a
corrupt newest checkpoint. The watchdog copy (train/watchdog.py) fires on
silence and not on beats. CPU only: the plain kernel versions."""

import time
import warnings

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import PRESETS
from bigdl_tpu_torch.models import llama
from bigdl_tpu_torch.train import (GaLore, ReLoRAState, adamw, init_lora,
                                   make_full_train_step, make_train_step,
                                   relora_reset, sample_lisa_mask)
from bigdl_tpu_torch.train.checkpoint import (list_train_checkpoints,
                                              load_latest_train_state,
                                              load_train_state,
                                              save_train_state,
                                              save_train_state_rotating)
from bigdl_tpu_torch.utils import durability
from bigdl_tpu_torch.utils.durability import IntegrityError

torch.set_num_threads(1)

CFG = PRESETS["tiny-llama"]
TOKENS = torch.from_numpy(np.random.default_rng(0).integers(1, 256, (2, 17))).long()
MASK = torch.ones((2, 17))


def _qbase():
    return llama.quantize_params(llama.init_params(CFG, 0, device="cpu"), "sym_int4")


def _qlora_run():
    lora = init_lora(CFG, seed=1, rank=4, device="cpu")
    opt = adamw(lora, 1e-2)
    return lora, opt, make_train_step(CFG, llama.forward, opt)


def test_qlora_kill_and_resume_reproduces_losses(tmp_path):
    base = _qbase()
    lora, _, step = _qlora_run()
    want = [step(base, lora, TOKENS, MASK).item() for _ in range(6)]

    lora, opt, step = _qlora_run()
    got = [step(base, lora, TOKENS, MASK).item() for _ in range(3)]
    path = str(tmp_path / "ckpt.npz")
    save_train_state(path, trainable=lora, optimizer=opt, step=3)

    lora2, opt2, step2 = _qlora_run()  # a new process: fresh objects
    st = load_train_state(path, trainable=lora2, optimizer=opt2, verify="full")
    assert st == {"step": 3, "resets": 0}
    got += [step2(base, lora2, TOKENS, MASK).item() for _ in range(3)]
    assert got == want
    save_train_state(path, trainable=lora2, optimizer=opt2, step=6)  # overwrite
    assert load_train_state(path, trainable=lora2, optimizer=opt2)["step"] == 6


def test_relora_mid_phase_resume_carries_the_merged_base(tmp_path):
    """ReLoRA's base changes at each merge: the checkpoint carries it, and
    a resume after the reset at step 2 reproduces the uninterrupted run."""

    def run(n, start=0, state=None, opt=None, ckpt=None):
        if state is None:
            lora = init_lora(CFG, seed=1, rank=4, device="cpu")
            opt = torch.optim.SGD(lora.parameters(), lr=5e-2)
            state = ReLoRAState(model=_qbase(), lora=lora)
        step = make_train_step(CFG, llama.forward, opt)
        losses = []
        for i in range(start, n):
            if i == 2 and (start < 2 or ckpt is None):
                state = relora_reset(CFG, state, opt, seed=9)
            losses.append(step(state.model, state.lora, TOKENS, MASK).item())
            if ckpt is not None and i + 1 == 3:
                save_train_state(ckpt, trainable=state.lora, optimizer=opt, step=3,
                                 base=state.model, resets=state.resets)
        return losses, state, opt

    want, _, _ = run(5)
    path = str(tmp_path / "relora.npz")
    got, _, _ = run(3, ckpt=path)
    lora = init_lora(CFG, seed=1, rank=4, device="cpu")
    opt = torch.optim.SGD(lora.parameters(), lr=5e-2)
    state = ReLoRAState(model=_qbase(), lora=lora)
    with pytest.raises(ValueError, match="base"):
        load_train_state(path, trainable=lora, optimizer=opt)
    st = load_train_state(path, trainable=lora, optimizer=opt, base=state.model)
    state.resets = st["resets"]
    assert st == {"step": 3, "resets": 1}
    more, _, _ = run(5, start=3, state=state, opt=opt, ckpt=path)
    assert got + more == want


def test_full_ft_galore_lisa_resume(tmp_path):
    """A GaLore full fine-tune (f32 weights, rank 8, refresh every 4 steps)
    with a LISA layer drawn per step from a torch.Generator: the model,
    GaLore's projectors and moments (an f32 projector kept f32 beside a
    bf16 norm), the step counts and the generator state round-trip."""

    def fresh():
        model = llama.init_params(CFG, 0, device="cpu", dtype=torch.float32)
        model.layers[0].attn_norm = torch.nn.Parameter(model.layers[0].attn_norm.detach().bfloat16())
        opt = GaLore(llama.make_trainable(model), lr=1e-3, rank=8, update_proj_gap=4)
        return model, opt, make_full_train_step(CFG, llama.forward, opt), torch.Generator().manual_seed(3)

    def steps(model, step, gen, n):
        return [step(model, TOKENS, MASK, sample_lisa_mask(gen, CFG.num_hidden_layers, 1)).item()
                for _ in range(n)]

    model, opt, step, gen = fresh()
    want = steps(model, step, gen, 6)
    model, opt, step, gen = fresh()
    got = steps(model, step, gen, 3)
    path = str(tmp_path / "full.npz")
    save_train_state(path, trainable=model, optimizer=opt, step=3, rng=gen)
    model, opt, step, gen = fresh()
    load_train_state(path, trainable=model, optimizer=opt, rng=gen)
    P = opt.state[model.layers[0].proj["wq"].weight]["proj"]
    assert P.dtype == torch.float32 and P.abs().sum() > 0
    assert opt.state[model.layers[0].attn_norm]["mu"].dtype == torch.bfloat16
    got += steps(model, step, gen, 3)
    assert got == want


def test_dtype_mismatch_is_refused_and_nothing_loads(tmp_path):
    lora, opt, _ = _qlora_run()
    path = str(tmp_path / "ck.npz")
    save_train_state(path, trainable=lora, optimizer=opt, step=1)
    bad = init_lora(CFG, seed=2, rank=4, dtype=torch.float16, device="cpu")
    before = {k: v.clone() for k, v in bad.state_dict().items()}
    with pytest.raises(ValueError, match="dtype|float16"):
        load_train_state(path, trainable=bad, optimizer=adamw(bad))
    for k, v in bad.state_dict().items():
        assert torch.equal(v, before[k])


def test_rotation_keeps_last_and_skips_corrupt(tmp_path):
    lora, opt, step = _qlora_run()
    base = _qbase()
    d = str(tmp_path / "rot")
    for s in range(1, 4):
        step(base, lora, TOKENS, MASK)
        save_train_state_rotating(d, step=s, keep_last=2, trainable=lora, optimizer=opt)
    paths = list_train_checkpoints(d)
    assert [p[-12:] for p in paths] == ["00000003.npz", "00000002.npz"]
    raw = bytearray(open(paths[0], "rb").read())
    raw[len(raw) // 2] ^= 0xFF  # rot one byte of the newest
    open(paths[0], "wb").write(bytes(raw))
    with pytest.raises(IntegrityError):
        load_train_state(paths[0], trainable=lora, optimizer=opt)
    failures = durability.VERIFY_FAILURES.value
    lora2, opt2, _ = _qlora_run()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        st = load_latest_train_state(d, trainable=lora2, optimizer=opt2)
    assert st["step"] == 2 and st["path"] == paths[1]
    assert any("skipping corrupt" in str(w.message) for w in caught)
    assert durability.VERIFY_FAILURES.value > failures


def test_watchdog_fires_on_silence_and_not_on_beats():
    """test_train_recipes.py's watchdog test against the port's copy."""
    from bigdl_tpu_torch.train.watchdog import StepWatchdog

    fired = []
    wd = StepWatchdog(timeout_s=2.0, check_interval_s=0.1,
                      on_timeout=lambda idle: fired.append(idle))
    for i in range(6):
        time.sleep(0.2)
        wd.beat(i)
    assert not fired
    time.sleep(3.0)
    assert len(fired) == 1 and fired[0] > 2.0
    wd.stop()
