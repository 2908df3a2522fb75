"""The training step as captured programs: the counterpart of npe_tpu's one
jitted chunk program (`npe_tpu/training/train_step.py:make_chunk_step`, a
`lax.scan` over the chunk with its state donated). On the card the G step and
the D step are each one CUDA graph, which the chunk loop
(`train_step.make_chunk_rows`) replays in the order the schedule, and the
guard, choose.

A `StepRunner` belongs to one chunk function (one module and cfg) and one
device and dtype. It holds static buffers: the train state (`state`), the
batch (`x`), z_rand (`z_rand`), the reparameterization noise (`noise`), the
learning rate (`lr`, a 0-d tensor in the masters' dtype) and one row of
metrics; and one `Program` per step kind, whose body runs that step
(`train_step.make_train_steps`) on the buffers, copies the new state into
them (`torch._foreach_copy_`) and stacks the step's metrics into the row.

The traps, and what is done about each:

* Warm-up without extra steps. A program's first call runs its body
  eagerly: a real step, which also warms the libraries up (cuDNN's plans,
  cuBLAS's workspace) on the stream the capture will use. Its second call
  captures the body and then replays the graph once, since a capture runs
  nothing: that replay is the step. Later calls replay. A chunk of n steps
  runs exactly n steps, and leaves the state and the generator where the
  eager chunk leaves them.
* The state in place, as npe_tpu's donation. The state a chunk returns is
  the runner's buffers, and the next chunk updates them in place: a state
  passed in is consumed, as with npe_tpu's `donate=True`
  (`npe_tpu/training/train_step.py:363`). A state that is not the runner's
  own is copied into the buffers at the chunk's start and left as it is. A
  caller that needs a state after the next chunk keeps a copy
  (`train_step.copy_state`), as the trainer's asynchronous checkpoint and
  its encoder-FID basis do.
* Random draws outside the graph. `step` writes z_rand and the noise into
  their buffers with `torch.randn(..., generator=gen, out=...)`, so the
  generator gives the single-process stream the eager chunk draws.
* Metrics are overwritten by every replay: `run` returns a clone of the
  row, taken after the step.
* Launch counters. The kernel wrappers count a launch when Python calls
  them, which a replay does not. A capture puts the counts back as they
  were before it and keeps what it added; every replay adds that. So the
  counts are the eager chunk's, and capturing adds nothing.
* Kernels inside a capture. Each wrapper reads
  `torch.cuda.current_stream()` when it is called, which under a capture is
  the capture stream, and the backward of a kernel is its plain version's
  VJP, library calls.
* The guard. The G and D graphs are separate; with
  cfg['adaptive_ratio_acc'] the chunk loop reads the decision on the host
  and replays the graph it chose. cfg['skip_nonfinite_updates'] is a
  `torch.where` inside the graphs.
* Freeing inside a capture. A graph, or its pool's memory, freed while
  another capture runs calls cudaFree, which invalidates that capture. The
  runner holds no reference cycle, so it and its graphs go when its chunk
  function goes, and `capture` keeps the cyclic collector off.
* The capture mode is "thread_local" (`Program`'s): a capture refuses the
  unsafe CUDA calls of its own thread only, so the trainer's asynchronous
  checkpoint thread, or another thread of the process, cannot invalidate it.
* Failure raises. A capture or a replay that fails raises; nothing falls
  back to eager steps.

On the CPU the same buffers and bodies run, each program called directly:
the caller asked for the CPU, where no graph exists. The two graphs share one
memory pool (they never run at once, and every tensor they allocate dies
inside its step), besides the buffers, which hold one more train state than
the eager chunk keeps.
"""

import weakref

import torch

from npe_tpu_torch.training.train_step import make_train_steps
# The capture machinery lives in utils/graphs.py; its names stay importable here.
from npe_tpu_torch.utils.graphs import COUNTERS, Program, add_counts, capture, read_counts  # noqa: F401
from npe_tpu_torch.utils.profiling import annotate


def flatten(tree, prefix=()):
    """[(path, tensor)] of a nested dict of tensors, in its order."""
    out = []
    for k, v in tree.items():
        out += flatten(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)]
    return out


def _empty_like_tree(tree):
    return {k: _empty_like_tree(v) if isinstance(v, dict) else torch.empty_like(v) for k, v in tree.items()}


class StepRunner:
    """The G and D steps of `module` under `cfg` over static buffers on
    x_like's device, in its dtype (the module docstring has the rules).
    `state` gives the train state's structure; `begin` loads one."""

    def __init__(self, module, cfg, state, x_like):
        gen_step, discrim_step = make_train_steps(module, cfg)
        bs, zdim = cfg["batch_size"], cfg["num_latents"]
        self.state = _empty_like_tree(state)
        self.leaves = flatten(self.state)
        self.x = x_like.new_empty((bs,) + tuple(x_like.shape[1:]))
        self.z_rand = x_like.new_empty((bs, zdim))
        self.noise = x_like.new_empty((bs, zdim))
        master = next(iter(self.state["parts"]["gen"].values()))
        self.lr = torch.zeros((), dtype=master.dtype, device=master.device)
        self.keys = self.row = None
        cuda = x_like.device.type == "cuda"
        stream = torch.cuda.Stream(x_like.device) if cuda else None
        pool = torch.cuda.graph_pool_handle() if cuda else None
        # the bodies reach the runner by a weak reference: no reference cycle,
        # so a runner that is dropped frees its graphs at once, never in a
        # later collection that could fall inside another capture
        me = weakref.ref(self)
        self.programs = {True: Program(lambda: me()._body(gen_step), stream, pool),
                         False: Program(lambda: me()._body(discrim_step), stream, pool)}

    def begin(self, state, lr):
        """Load `state` (its tensors not yet the buffers are copied in) and
        the learning rate (a Python float or a 0-d tensor)."""
        theirs = flatten(state)
        if [p for p, _ in theirs] != [p for p, _ in self.leaves]:
            raise ValueError("the train state's structure is not the one this runner was made for")
        dst, src = [], []
        for (path, d), (_, s) in zip(self.leaves, theirs):
            if s is not d:
                if s.shape != d.shape or s.dtype != d.dtype or s.device != d.device:
                    raise ValueError(f"state {'/'.join(path)}: {tuple(s.shape)} {s.dtype} on {s.device}, "
                                     f"the runner's is {tuple(d.shape)} {d.dtype} on {d.device}")
                dst.append(d)
                src.append(s)
        if dst:
            torch._foreach_copy_(dst, src)
        if isinstance(lr, torch.Tensor):
            self.lr.copy_(lr)
        else:
            self.lr.fill_(lr)

    def _body(self, step_fn):
        new, m = step_fn(self.state, self.x, self.z_rand, self.noise, self.lr)
        new = dict(flatten(new))
        if sorted(new) != sorted(p for p, _ in self.leaves):
            raise ValueError("a step changed the train state's structure")
        pairs = [(d, new[p]) for p, d in self.leaves if new[p] is not d]
        torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])
        if self.keys is None:
            self.keys = list(m)
            self.row = torch.empty(len(m), dtype=torch.float32, device=self.x.device)
        if list(m) != self.keys:
            raise ValueError(f"the G and D steps report other metrics: {list(m)} and {self.keys}")
        torch.stack([m[k].to(torch.float32) for k in self.keys], out=self.row)

    def run(self, is_gen):
        """One G (`is_gen`) or D step on the buffers as they are; returns its
        metrics as a new float32 row in the order of `keys`."""
        self.programs[bool(is_gen)]()
        return self.row.clone()

    def step(self, is_gen, xb, gen):
        """The chunk loop's step: the batch `xb` into `x`, z_rand then the
        noise drawn from `gen` into theirs, then `run`; under a profiler one
        span, `npe.step.G` or `npe.step.D`."""
        with annotate("npe.step.G" if is_gen else "npe.step.D"):
            self.x.copy_(xb)
            torch.randn(self.z_rand.shape, generator=gen, out=self.z_rand)
            torch.randn(self.noise.shape, generator=gen, out=self.noise)
            return self.run(is_gen)
