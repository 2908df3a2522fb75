"""The IAN trainer (npe_tpu `training/train.py`, reference
`train_IAN.py:378-581`).

Keeps the reference's observable behavior -- chunked epochs, alternating G/D
updates by `itr % (update_ratio+1)`, per-chunk JSONL metrics with the
periodic header table, per-epoch 6x9 sample/interpolation grids, name-keyed
.npz weight checkpoints with {epoch, itr, ts, learning_rate} metadata, and
`--resume` -- and, as npe_tpu does, checkpoints the optimizer state too (the
reference restarted Adam's moments from zero).

On the card: each chunk is staged by ONE kernel launch
(`ops.kernels.staging.stage_chunk`: gather + uint8 -> float32 + range
change), either out of the whole uint8 dataset resident in device memory or
out of the chunk's bytes sent up from pinned host memory, the bytes of the
in-process dataset or of the native C++ loader's chunks (`native:<raw>`);
the G and D steps run as two captured CUDA graphs (`training/captured.py`,
npe_tpu's one-program chunk; on the CPU the same static buffers with each
step called directly), in float32 or, with cfg['compute_dtype'] = 'bfloat16'
(`--compute-dtype`), in bf16 over float32 masters; the learning rate is a
0-d device tensor that the steps read, so a new rate needs no new capture;
and the chunk's metrics come to the host in one copy. The state a chunk
returns is updated in place by the next, so an asynchronous checkpoint
writes a copy of it, and the encoder-FID basis is a copy. With a validation
set each checkpoint also reports the encoder-FID (`training/quality.py`) in
a frozen feature space; the checkpoints' grids, validation and encoder-FID
run as captured programs (`training/programs.py`, npe_tpu's jitted
evaluation functions), which a run captures at its first checkpoint;
`profile_dir` traces the first chunk
(`utils/profiling.py`), its staging and steps under the port's `npe.*` spans
(`npe.chunk` around them): its first G and first D step run eagerly, the second
of each is captured (the trace shows `cudaStreamBeginCapture` /
`cudaGraphInstantiate` on the host and no kernels of its own) and replayed,
and every later step is one `cudaGraphLaunch` whose kernels the trace lists
as the card's. Under a mesh the steps stay eager.

Data-parallel (`train(mesh=...)`, `--data-parallel`, npe_tpu's sharded
trainer): every rank loads the same chunk and the same permutation (rank
0's, broadcast) and stages only its rows of each global batch, in one
`staging` launch; the steps compute one process's step on the global batch
(`training.train_step`, `parallel/`); metrics, the JSONL, grids,
checkpoints (whole arrays, npe_tpu's format), validation and encoder-FID
run on rank 0 while the others wait at a barrier (on a group of its own
whose timeout is CHECKPOINT_WAIT, a day: that work has no fixed length, and
the setup timeout of `parallel.multihost.init_multihost` bounds only the
default group); `--resume` reads on every rank. The dataset cache on the card stays single-device, as in npe_tpu.

CLI: python -m npe_tpu_torch.training.train IAN_simple --resume=True ...
     torchrun --nproc-per-node N -m npe_tpu_torch.training.train IAN_simple --data-parallel
"""

import argparse
import contextlib
import datetime
import logging
import os
import time
from collections import OrderedDict

import numpy as np
import torch
import torch.distributed as dist

from npe_tpu_torch.data import data_loader, get_dataset, index_loader
from npe_tpu_torch.data import native_loader
from npe_tpu_torch.models import get_config
from npe_tpu_torch.ops.kernels import rgb_beta_tail
from npe_tpu_torch.ops.kernels.staging import stage_chunk
from npe_tpu_torch.parallel.mesh import (
    broadcast_from_first, gather_train_state, make_mesh, shard_train_state, state_layout,
)
from npe_tpu_torch.parallel.multihost import init_multihost
from npe_tpu_torch.training import train_step as TS
from npe_tpu_torch.training.eval_grids import sample_and_interp_grid
from npe_tpu_torch.training.evaluate import validation_pixel_accuracy
from npe_tpu_torch.training.programs import EvalPrograms
from npe_tpu_torch.training.quality import encoder_fid
from npe_tpu_torch.utils import checkpoints, profiling
from npe_tpu_torch.utils.device import resolve_device
from npe_tpu_torch.utils.metrics_logging import MetricsLogger

GEN_KEYS = ["gen_recon_loss", "gen_sample_loss", "pixel_loss", "feature_loss", "pixel_acc"]
DISCRIM_KEYS = ["discrim_g_loss", "discrim_d_loss", "discrim_acc", "pixel_loss", "pixel_acc"]

CHECKPOINT_WAIT = datetime.timedelta(days=1)  # the longest rank 0's checkpoint step may take


class AdaptiveRatioGuard:
    """D-saturation guard (npe_tpu's documented deviation from the
    reference's fixed alternation): when the discriminator's running accuracy
    EMA exceeds `threshold`, scheduled D steps are skipped (G trains
    instead). While skipping, the EMA decays toward chance (0.5) -- D is not
    being measured, and an EMA frozen at its last saturated value would
    latch the guard on forever. The decay bounds the skip streak: after a
    few skips the EMA re-crosses the threshold and the next scheduled D step
    probes the real accuracy, re-engaging immediately if D is still
    saturated.

    This class is the HOST-SIDE statement of the semantics (and the oracle
    the tests check against); the trainer runs the same decision inside the
    chunk loop with the EMA on the device (train_step.guard_schedule /
    guard_ema_update)."""

    def __init__(self, threshold, period, decay=0.9, chance=0.5):
        self.threshold = threshold
        self.period = period
        self.decay = decay
        self.chance = chance
        self.ema = 0.5

    def should_gen(self, itr):
        """True if step `itr` should train G (either by the faithful
        alternation or because the guard is skipping a saturated D).

        CONTRACT: call exactly once per training step -- a skip decision
        decays the EMA as a side effect (that decay is what bounds the skip
        streak), so a second call for the same `itr` would double-decay and
        change the G/D schedule."""
        if itr % self.period == 0:
            return True
        if self.ema > self.threshold:
            self.ema = self.decay * self.ema + (1 - self.decay) * self.chance
            return True
        return False

    def observe(self, d_acc):
        """Feed the accuracy measured by a D step that actually ran."""
        self.ema = self.decay * self.ema + (1 - self.decay) * float(d_acc)


def current_lr(cfg, epoch, lr):
    if isinstance(cfg["learning_rate"], dict):
        if epoch in cfg["learning_rate"]:
            new = cfg["learning_rate"][epoch]
            if new != lr:
                logging.info("Changing learning rate from %s to %s", lr, new)
            return float(new)
    if cfg.get("decay_rate") and epoch > 0:
        return lr * (1 - cfg["decay_rate"])
    return lr


def restore_masks(loaded, fresh_state):
    """The train state persists the MADE masks (the IAF connectivity
    ordering), so resume uses the checkpointed ones rather than regenerating
    from init. Backfill from fresh init only for train states that lack
    them."""
    for k, v in fresh_state["parts"]["state"].items():
        if k.endswith(".weights_mask") and k not in loaded["parts"]["state"]:
            loaded["parts"]["state"][k] = v
    return loaded


def fetch_scalars(*dicts):
    """Dicts of 0-d device tensors -> dicts of Python floats, in ONE
    device-to-host copy."""
    values = [v for d in dicts for v in d.values()]
    host = iter(())
    if values:
        stacked = torch.stack([v.to(torch.float32) for v in values])
        with profiling.annotate("npe.wait"):
            host = iter(stacked.cpu().tolist())
    return [{k: next(host) for k in d} for d in dicts]


def train(
    config="IAN_simple",
    dataset_spec="synthetic",
    resume=False,
    max_epochs=None,
    num_examples=4096,
    out_dir=".",
    pics_dir="pics",
    seed=0,
    checkpoint_grids=True,
    cfg_overrides=None,
    profile_dir=None,
    valid_dataset_spec=None,
    num_valid_examples=1024,
    fid_feature_weights=None,
    state_every=1,
    async_checkpoint=False,
    device="cuda",
    device_cache_bytes=2 << 30,
    mesh=None,
):
    """Train `config` and return the final train state. Runs on the card;
    without one it raises unless the caller asks for `device="cpu"`.

    `device_cache_bytes`: when the whole uint8 dataset fits this budget it
    goes to device memory ONCE and each chunk is gathered there from a
    per-chunk index vector; else each chunk's bytes go up from pinned host
    memory. Either way one `stage_chunk` launch stages the chunk.
    `dataset_spec` 'native:<raw>': chunks come from the native loader over a
    raw uint8 record file (`data.native_loader.export_raw`), always up from
    pinned memory; the grids draw on `SyntheticFaces`.
    `profile_dir`: a `torch.profiler` trace of the first chunk.
    `fid_feature_weights`: a weights file that fixes the encoder-FID feature
    space; without it the first validation checkpoint does, saved to
    `<name>_fid_basis.npz` and read back on resume.
    `mesh` (`parallel.mesh.make_mesh`, on every rank): data-parallel over
    its 'data' axis, with the weights it names held in 'model' slices; the
    run is on the mesh's device, and the files are rank 0's. Returns this
    rank's state (its slices)."""
    device = mesh.device if mesh is not None else resolve_device(device)
    lead = mesh is None or mesh.rank == 0
    module = get_config(config)
    cfg = dict(module.cfg)
    if max_epochs is not None:
        cfg["max_epochs"] = max_epochs
    if cfg_overrides:
        cfg.update(cfg_overrides)

    name = cfg["model"]
    os.makedirs(out_dir, exist_ok=True)
    weights_fname = os.path.join(out_dir, name + ".npz")
    state_fname = os.path.join(out_dir, name + "_train_state.npz")
    metrics_fname = os.path.join(out_dir, name + "METRICS.jsonl")

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s| %(message)s")
    if lead:
        logging.info("Metrics will be saved to %s", metrics_fname)
    mlog = MetricsLogger(metrics_fname, reinitialize=not resume) if lead else None

    variables = module.init(torch.Generator().manual_seed(seed), device)
    state = TS.init_train_state(module, variables, cfg)
    layout = state_layout(state, mesh)  # names and shapes only: a resumed state has the same
    # the other ranks wait for rank 0's checkpoint, grids and validation on this group
    waiting = dist.new_group(timeout=CHECKPOINT_WAIT) if mesh is not None and mesh.size > 1 else None
    adaptive_acc = cfg.get("adaptive_ratio_acc")
    chunk_step = TS.make_chunk_step(module, cfg, cfg["batches_per_chunk"], guard_acc=adaptive_acc, mesh=mesh,
                                    layout=layout)

    itr = 0
    min_epoch = 0
    lr = float(cfg["learning_rate"][0] if isinstance(cfg["learning_rate"], dict) else cfg["learning_rate"])
    if resume and os.path.isfile(state_fname):
        state = restore_masks(checkpoints.load_train_state(state_fname, device), state)
        # Prefer the state file's own metadata: with state_every>1 the
        # weights file can be NEWER than the opt state, and epoch/lr must
        # stay consistent with the params+moments actually restored.
        meta = checkpoints.train_state_metadata(state_fname)
        if not meta and os.path.isfile(weights_fname):
            meta = checkpoints.load_weights(weights_fname, {})
        min_epoch = int(meta.get("epoch", -1)) + 1
        itr = int(meta.get("itr", 0))
        lr = float(meta.get("learning_rate", lr))
        logging.info("resumed: epoch=%d itr=%d lr=%g", min_epoch, itr, lr)
    if mesh is not None:
        state = shard_train_state(state, mesh, layout)

    native = None
    if str(dataset_spec).startswith("native:"):
        raw_path = str(dataset_spec)[len("native:"):]
        native = native_loader.NativeChunkLoader(raw_path, native_loader.num_records(raw_path), (3, 64, 64),
                                                 cfg["batch_size"] * cfg["batches_per_chunk"])
        dataset = get_dataset("synthetic", num_examples=num_examples)  # for the grids
    else:
        dataset = get_dataset(dataset_spec, num_examples=num_examples)
    device_cache = None
    n_ex = dataset.num_examples
    if native is None and mesh is None and n_ex * 3 * 64 * 64 <= device_cache_bytes:
        device_cache = torch.from_numpy(np.uint8(dataset.get_data(np.arange(n_ex)))).to(device)
    valid_dataset = (
        get_dataset(valid_dataset_spec, num_examples=num_valid_examples) if valid_dataset_spec else None
    )
    # Adaptive-ratio guard state: the accuracy EMA lives on the device
    # between chunks. Like the host guard it starts at chance on every
    # (re)start -- it is measurement state, not model state, and re-converges
    # within ~10 D steps.
    guard_ema = torch.tensor(TS.GUARD_CHANCE, dtype=torch.float32, device=device) if adaptive_acc else None
    checkpoint_count = 0
    gen = torch.Generator(device).manual_seed(seed + 1)  # z_rand and the reparameterization noise
    offset = True
    # Frozen feature space for encoder-FID: a passed checkpoint, else the
    # first validation checkpoint of this run, persisted to
    # <name>_fid_basis.npz so that a resume keeps the same feature space
    # (otherwise every resume would rebase the FID curve on whatever the
    # encoder looks like at its first checkpoint).
    # The checkpoints' grids, validation and encoder-FID run as captured
    # programs (`training/programs.py`) of two owners made once a run on rank
    # 0: one holds the current weights, loaded once a checkpoint; the other
    # the FID basis, loaded once, whose buffers the chunks' in-place updates
    # never reach.
    fid_basis_fname = os.path.join(out_dir, name + "_fid_basis.npz")
    eval_programs = EvalPrograms(module, device) if lead else None
    fid_programs = None
    fid_basis = fid_feature_weights or (fid_basis_fname if os.path.isfile(fid_basis_fname) else None)
    if fid_basis and lead:
        basis = module.init(torch.Generator().manual_seed(seed), device)
        meta = checkpoints.load_weights(fid_basis, basis)
        fid_programs = EvalPrograms.of(module, basis)
        del basis
        logging.info("encoder-FID feature basis from %s (epoch %s)", fid_basis, meta.get("epoch"))

    ckptr = checkpoints.AsyncCheckpointer() if async_checkpoint and lead else None
    lr_dev = torch.tensor(lr, dtype=torch.float32, device=device)  # what the steps read
    # Consecutive checkpoint-WRITE failures (disk full, permissions...):
    # one is survivable (the previous atomic checkpoint is intact, the next
    # save retries), but a persistent failure would silently leave a long run
    # with stale checkpoints -- escalate so the operator notices.
    save_failures = [0]

    for epoch in range(min_epoch, cfg["max_epochs"]):
        offset = not offset
        lr = current_lr(cfg, epoch, lr)
        lr_dev.fill_(lr)
        loader_args = dict(offset=offset * cfg["batch_size"] // 2, shuffle=cfg["shuffle"], seed=epoch)
        if native is not None:
            loader = native_loader.native_chunk_loader(cfg, None, None, loader=native, raw=True, **loader_args)
        elif device_cache is not None:
            loader = index_loader(cfg, dataset.num_examples, **loader_args)
        else:
            loader = data_loader(cfg, dataset, raw=True, **loader_args)
        iter_counter = 0
        for x_chunk in loader:
            iter_counter += 1
            num_batches = len(x_chunk) // cfg["batch_size"]
            perm = np.random.permutation(len(x_chunk))
            if mesh is not None:
                # rank 0's order; this rank's rows of each global batch, in batch order
                perm = broadcast_from_first(perm, mesh)
                perm = perm.reshape(num_batches, mesh.data.size, -1)[:, mesh.data.index].reshape(-1)
            assert num_batches == cfg["batches_per_chunk"], (num_batches, cfg["batches_per_chunk"])
            traced = profile_dir and epoch == min_epoch and iter_counter == 1
            with (profiling.device_trace(profile_dir) if traced else contextlib.nullcontext(),
                  profiling.annotate("npe.chunk")):
                # Chunks arrive as raw uint8 NCHW (or as index vectors into the
                # device-resident cache); the host ships the bytes as they are
                # and ONE kernel does gather + cast + to_tanh on the card.
                if device_cache is not None:
                    x_dev = stage_chunk(device_cache, np.asarray(x_chunk)[perm])
                else:
                    u8 = torch.from_numpy(x_chunk)
                    if device.type == "cuda":
                        u8 = u8.pin_memory().to(device, non_blocking=True)
                    x_dev = stage_chunk(u8, perm)
                if guard_ema is None:
                    state, gen_m, dis_m, n_gen = chunk_step(state, x_dev, itr, gen, lr_dev)
                else:
                    state, gen_m, dis_m, n_gen, guard_ema = chunk_step(state, x_dev, itr, gen, lr_dev, guard_ema)
                # one copy for the chunk's ~20 scalar metrics
                gen_m, dis_m = fetch_scalars(gen_m, dis_m)
            if traced:
                logging.info("profiler trace of the first chunk written to %s", profile_dir)
            n_dis = num_batches - n_gen
            metrics = OrderedDict()
            for k in list(dict.fromkeys(GEN_KEYS + DISCRIM_KEYS)):
                if k in GEN_KEYS and k in DISCRIM_KEYS:
                    metrics[k] = (gen_m[k] * n_gen + dis_m[k] * n_dis) / num_batches
                elif k in GEN_KEYS:
                    if n_gen:
                        metrics[k] = gen_m[k]
                elif n_dis:
                    metrics[k] = dis_m[k]
            if guard_ema is not None:
                # D-slots the guard converted to G steps this chunk -- the
                # faithful alternation schedules ceil(nb/period) G steps.
                period = cfg["update_ratio"] + 1
                scheduled_g = sum(1 for i in range(num_batches) if (itr + i) % period == 0)
                metrics["d_steps_skipped"] = float(n_gen - scheduled_g)
            itr += num_batches
            if not lead:
                continue

            if (iter_counter - 1) % 50 == 0:
                logging.info("epoch   itr    " + "  ".join(metrics))
            logging.info(
                "%4d %6d  " % (epoch, itr)
                + "  ".join(("%" + str(len(k)) + ".4f") % v for k, v in metrics.items())
            )
            mlog.log(epoch=epoch, itr=itr, metrics=metrics)

        if not (epoch % cfg["checkpoint_every_nth"]) or epoch == cfg["max_epochs"] - 1:
            checkpoint_count += 1
            whole = gather_train_state(state, mesh, layout)  # every rank of a 'model' axis takes part
            if not lead:
                dist.barrier(group=waiting)  # rank 0 writes the checkpoint, the grids and the validation
                continue
            variables = TS.variables_of(whole)
            if checkpoint_grids or valid_dataset is not None:
                eval_programs.load(variables)
            if checkpoint_grids:
                os.makedirs(pics_dir, exist_ok=True)
                sample_and_interp_grid(
                    module, variables, dataset, os.path.join(pics_dir, f"{name}_{epoch}.png"),
                    seed=epoch * 42 + 5, programs=eval_programs,
                )
            meta = {"epoch": epoch, "itr": itr, "ts": time.time(), "learning_rate": lr}
            # A full state is about three times the weights, so state_every>1
            # throttles the state save (weights still save every checkpoint,
            # like the reference's per-epoch npz, `train_IAN.py:567-571`).
            # Metadata rides in the state file so a resume stays
            # epoch-consistent with the moments.
            save_full_state = (
                (checkpoint_count - 1) % state_every == 0 or epoch == cfg["max_epochs"] - 1
            )

            def _do_save(dev_state, meta=meta, full=save_full_state):
                # A failed WRITE (disk/fs-level OSError) must not kill a long
                # run: the previous checkpoint is still on disk (atomic
                # rename) and the next checkpoint retries.
                try:
                    checkpoints.save_weights(weights_fname, TS.variables_of(dev_state), meta)
                    if full:
                        checkpoints.save_train_state(state_fname, dev_state, metadata=meta)
                    save_failures[0] = 0
                except OSError as e:
                    save_failures[0] += 1
                    if save_failures[0] >= 3:
                        logging.error(
                            "checkpoint save failed %d times in a row; the "
                            "checkpoint path is broken, aborting: %s",
                            save_failures[0],
                            e,
                        )
                        raise
                    logging.warning("checkpoint save failed (will retry next checkpoint): %s", e)

            if ckptr is not None:
                # The copy to the host and the write run on the checkpoint
                # thread against a copy of the epoch-N state made on the card
                # (the next chunk updates the state in place), while epoch
                # N+1 trains.
                ckptr.submit(_do_save, TS.copy_state(whole))
            else:
                _do_save(whole)
            if valid_dataset is not None:
                ev = validation_pixel_accuracy(module, variables, valid_dataset, cfg, max_chunks=1,
                                               programs=eval_programs)
                # the FID batch clamped to the validation set, so that a small
                # set still yields one chunk (evaluate.py clamps the same way)
                n_fid = min(256, valid_dataset.num_examples)
                fid_bs = min(cfg["batch_size"], n_fid)
                fid_cfg = {**cfg, "batch_size": fid_bs, "batches_per_chunk": max(1, n_fid // fid_bs)}
                real = next(iter(data_loader(fid_cfg, valid_dataset, offset=0)), None)
                if real is None:
                    ev["encoder_fid"] = float("nan")
                else:
                    # The FIRST validation checkpoint freezes the feature space
                    # (quality.py: FIDs from a drifting encoder conflate encoder
                    # movement with sample quality), in the basis owner's
                    # buffers, a copy: the next chunk updates the state's
                    # tensors in place.
                    if fid_programs is None:
                        fid_programs = EvalPrograms.of(module, variables)
                        checkpoints.save_weights(fid_basis_fname, fid_programs.variables, {"epoch": epoch})
                    ev["encoder_fid"] = encoder_fid(module, variables, real, num=min(n_fid, len(real)), seed=epoch,
                                                    programs=eval_programs, feature_programs=fid_programs)
                logging.info("validation: pixel_acc=%.4f mse=%.4f encoder_fid=%.3f", ev["test_error"], ev["mse"],
                             ev["encoder_fid"])
                mlog.log(epoch=epoch, itr=itr, validation=ev)
            if waiting is not None:
                dist.barrier(group=waiting)

    if ckptr is not None:
        ckptr.close()
    if native is not None:
        native.close()
    logging.info("training done; kernel launches in this process: staging %d, rgb_beta_tail %d",
                 stage_chunk.launches, rgb_beta_tail.rgb_beta_tail.launches)
    return state


def data_parallel_mesh(device="cuda"):
    """The mesh of `--data-parallel`: under torchrun (RANK and WORLD_SIZE,
    MASTER_ADDR and MASTER_PORT in the environment) this rank's process
    group, `parallel.multihost.init_multihost`'s (NCCL on a card, gloo on the
    CPU), every rank on 'data'; alone, a world of one, as npe_tpu's
    `make_mesh()` on one device."""
    if "RANK" not in os.environ:
        return make_mesh(devices=[resolve_device(device)])
    return init_multihost("env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]), device)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("config_path", help="model config name or path (IAN, IANv1, IAN_simple)")
    # NOT type=bool: bool("False") is True, so any value would resume.
    # Accepts the reference's `--resume=True` spelling (`train_IAN.py:580`).
    p.add_argument(
        "--resume",
        type=lambda s: s.strip().lower() in ("1", "true", "yes"),
        default=False,
    )
    p.add_argument(
        "--dataset",
        default="synthetic",
        help="'synthetic', 'real', 'real:<dir>', 'composite', a path to .npz/.hdf5, or 'native:<raw>'",
    )
    p.add_argument("--valid-dataset", default=None, help="validation dataset spec")
    p.add_argument("--out-dir", default=".", help="where checkpoints/metrics are written")
    p.add_argument("--pics-dir", default="pics", help="where sample grids are written")
    p.add_argument("--max-epochs", type=int, default=None)
    p.add_argument("--num-examples", type=int, default=4096)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--batches-per-chunk", type=int, default=None)
    p.add_argument("--checkpoint-every", type=int, default=None)
    p.add_argument("--data-parallel", action="store_true",
                   help="data-parallel over the ranks torchrun starts (alone: a world of one)")
    p.add_argument(
        "--compute-dtype",
        default=None,
        help="mixed-precision compute dtype for the train step (bfloat16); master weights, optimizer "
        "and BN statistics stay float32",
    )
    p.add_argument(
        "--moments-dtype",
        default=None,
        help="storage dtype for the Adam m/v moments (e.g. bfloat16); the "
        "update arithmetic stays float32. Off (float32 moments) for the "
        "faithful recipes",
    )
    p.add_argument(
        "--skip-nonfinite-updates",
        action="store_true",
        help="drop any step whose gradients contain inf/NaN instead of "
        "poisoning the parameters; off by default to keep the faithful "
        "recipes exactly the reference's semantics",
    )
    p.add_argument(
        "--adaptive-ratio-acc",
        type=float,
        default=None,
        help="D-saturation guard threshold: scheduled D steps train G instead "
        "while the discriminator-accuracy EMA exceeds this value; off "
        "(faithful fixed alternation) by default",
    )
    p.add_argument(
        "--state-every",
        type=int,
        default=1,
        help="save the full optimizer state every Nth checkpoint (weights "
        "still save every checkpoint); resume restores from the last state save",
    )
    p.add_argument("--profile-dir", default=None, help="write a torch.profiler trace of the first chunk")
    p.add_argument(
        "--async-checkpoint",
        action="store_true",
        help="copy out and write checkpoints on a background thread so "
        "training continues meanwhile (saves stay ordered and atomic)",
    )
    p.add_argument(
        "--fid-feature-weights",
        default=None,
        help="checkpoint defining the frozen encoder-FID feature space "
        "(default: this run's first validation checkpoint)",
    )
    p.add_argument("--device", default="cuda", help="'cuda' (the default; raises without one) or 'cpu'")
    a = p.parse_args(argv)
    mesh = data_parallel_mesh(a.device) if a.data_parallel else None
    overrides = {}
    if a.batch_size:
        overrides["batch_size"] = a.batch_size
    if a.batches_per_chunk:
        overrides["batches_per_chunk"] = a.batches_per_chunk
    if a.checkpoint_every:
        overrides["checkpoint_every_nth"] = a.checkpoint_every
    if a.compute_dtype:
        overrides["compute_dtype"] = a.compute_dtype
    if a.moments_dtype:
        overrides["moments_dtype"] = a.moments_dtype
    if a.skip_nonfinite_updates:
        overrides["skip_nonfinite_updates"] = True
    if a.adaptive_ratio_acc:
        overrides["adaptive_ratio_acc"] = a.adaptive_ratio_acc
    train(
        config=a.config_path,
        dataset_spec=a.dataset,
        resume=a.resume,
        max_epochs=a.max_epochs,
        num_examples=a.num_examples,
        out_dir=a.out_dir,
        pics_dir=a.pics_dir,
        cfg_overrides=overrides,
        profile_dir=a.profile_dir,
        valid_dataset_spec=a.valid_dataset,
        fid_feature_weights=a.fid_feature_weights,
        state_every=a.state_every,
        async_checkpoint=a.async_checkpoint,
        device=a.device,
        mesh=mesh,
    )
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
