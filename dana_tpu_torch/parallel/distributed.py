"""Multi-process runs (port of dana_tpu/parallel/distributed.py).

PyTorch's process model: one process per device.  `init_distributed`
joins this process into a `torch.distributed` group; rank r drives
`cuda:(local_rank % device_count)` (`rank_device`), its local rank its
index among the ranks on its host.  The backend is NCCL when every rank
has a card of its own (no host holds more ranks than cards), else gloo
(NCCL refuses two ranks on one device; gloo also runs on the CPU).  Gloo has
`all_reduce` and `broadcast` for CUDA tensors but no `all_gather`, so
every gather here is an all-reduce of a zero-filled global buffer into
which each rank writes its rows (`BatchGroup.gather`).

Each process loads only its row block of every global batch
(`local_rows`; `data/fs_loader.py` `EpisodicBatcher(process_id=,
process_count=)`), and the training step sees the global batch where a
per-rank mean would differ: `BatchGroup` is the reduction context the
losses, the target layers' draws and the batch-statistics BatchNorm read
(`current_group()`).  Entered on one process it is the identity, and every
path runs as it does without it.  Across W ranks each loss returns its
local numerator times W over the global count, so that the mean of the
ranks' gradients, which `engine/train.py` `Trainer.update` forms with one
flattened all-reduce, is the gradient of the global batch's loss.

`barrier` and `agree_stop` ride gloo on the CPU (a gloo side group when
the default backend is NCCL): `monitored_barrier` takes a timeout, which
NCCL's barrier does not.
"""

from __future__ import annotations

import collections
import contextvars
import datetime
import json
import os
import socket
import threading

import torch
import torch.distributed as dist

_SIDE = None        # the gloo group of barrier / agree_stop under NCCL
_LOCAL_RANK = 0     # this rank's index among the ranks of its host


def _env_int(name):
    v = os.environ.get(name)
    return None if v is None else int(v)


def local_rank() -> int:
    """This process's index among the ranks of its host: LOCAL_RANK when
    a launcher set it, else the index `init_distributed` found among the
    ranks that share this host's name, else 0."""
    v = _env_int('LOCAL_RANK')
    return _LOCAL_RANK if v is None else v


def rank_device(device='cuda') -> torch.device:
    """The device this rank drives: cuda:(local_rank % device_count), or
    the CPU when `device` is 'cpu'."""
    dev = torch.device(device)
    if dev.type != 'cuda':
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available; pass device="cpu" to run '
                           'the plain PyTorch versions of the kernels')
    return torch.device('cuda', local_rank() % torch.cuda.device_count())


def choose_backend(hosts, device='cuda') -> str:
    """'nccl' when every rank has a card of its own, else 'gloo' (ranks
    that share a card, or the CPU).  hosts: every rank's (host name, card
    count); a host's ranks have cards of their own when they number no
    more than its cards."""
    if torch.device(device).type != 'cuda':
        return 'gloo'
    ranks = collections.Counter(name for name, _ in hosts)
    cards = dict(hosts)
    return 'nccl' if all(n <= cards[h] for h, n in ranks.items()) \
        else 'gloo'


def _exchange_hosts(store, rank, world, device) -> list:
    """Every rank's (host name, card count), through the rendezvous's
    store."""
    cards = torch.cuda.device_count() \
        if torch.device(device).type == 'cuda' else 0
    store = dist.PrefixStore('dana_hosts', store)
    store.set(str(rank), json.dumps([socket.gethostname(), cards]))
    return [tuple(json.loads(store.get(str(r)))) for r in range(world)]


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device='cuda') -> 'BatchGroup':
    """Join this process into the group of `num_processes` ranks as
    `process_id`, through `coordinator`: 'host:port' (rank 0 listens
    there) or an init method URL such as 'file:///path' (a FileStore).
    Absent arguments come from torchrun's environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT).  The ranks tell each other their host and
    its card count through the rendezvous, and every rank takes the same
    `choose_backend`.  -> the BatchGroup of the world."""
    global _SIDE, _LOCAL_RANK
    if num_processes is None:
        num_processes = _env_int('WORLD_SIZE')
    if process_id is None:
        process_id = _env_int('RANK')
    if num_processes is None or process_id is None:
        raise ValueError('init_distributed needs the process count and this '
                         'process\'s id (--num_procs / --proc_id, or '
                         'torchrun\'s WORLD_SIZE / RANK)')
    if coordinator:
        init = coordinator if '://' in coordinator else f'tcp://{coordinator}'
    else:
        init = 'env://'
    store, _, _ = next(dist.rendezvous(init, process_id, num_processes))
    hosts = _exchange_hosts(store, process_id, num_processes, device)
    _LOCAL_RANK = [r for r, (name, _) in enumerate(hosts)
                   if name == hosts[process_id][0]].index(process_id)
    backend = choose_backend(hosts, device)
    if backend == 'nccl' and not dist.is_nccl_available():
        backend = 'gloo'
    if backend == 'nccl':
        torch.cuda.set_device(rank_device(device))
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id)
    _SIDE = dist.new_group(backend='gloo') if backend != 'gloo' else None
    return BatchGroup(process_id, num_processes)


def shutdown():
    """Leave the process group (a no-op when none was joined)."""
    global _SIDE, _LOCAL_RANK
    if dist.is_initialized():
        dist.destroy_process_group()
    _SIDE, _LOCAL_RANK = None, 0


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier(name: str, timeout_ms: int | None = None) -> None:
    """Block until every process reaches this barrier, or raise after
    `timeout_ms` (default DANA_BARRIER_TIMEOUT_S seconds, 600).  A gloo
    `monitored_barrier`, which names the ranks that did not arrive.
    Callers waiting on work whose skew across ranks is unbounded (a whole
    detection pass) pass a timeout sized to that work.  No-op on one
    process."""
    if not is_multiprocess():
        return
    if timeout_ms is None:
        timeout_ms = 1000 * int(os.environ.get('DANA_BARRIER_TIMEOUT_S',
                                               '600'))
    try:
        dist.monitored_barrier(group=_SIDE,
                               timeout=datetime.timedelta(
                                   milliseconds=timeout_ms),
                               wait_all_ranks=True)
    except RuntimeError as e:
        raise RuntimeError(f'barrier {name!r}: {e}') from e


def agree_stop(local_flag: bool) -> bool:
    """The OR of every process's flag (the stop vote): a rank that left
    the training loop alone would strand its peers in the next step's
    all-reduce, so every rank calls this at the same loop boundary and all
    get one answer.  The local flag on one process."""
    if not is_multiprocess():
        return bool(local_flag)
    vote = torch.tensor([1 if local_flag else 0], dtype=torch.int32)
    dist.all_reduce(vote, group=_SIDE)
    return bool(vote.item() > 0)


def local_rows(global_batch_size: int, process_id: int | None = None,
               process_count: int | None = None) -> slice:
    """The contiguous row block of each global batch that this process
    loads (rank order)."""
    pid = process_index() if process_id is None else process_id
    pc = _world_size() if process_count is None else process_count
    if global_batch_size % pc:
        raise ValueError(
            f'global batch {global_batch_size} must divide evenly over '
            f'{pc} processes')
    per = global_batch_size // pc
    return slice(pid * per, (pid + 1) * per)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks, whose gradient is the sum over the ranks of
    the incoming gradients (each rank's loss reads the global sum)."""

    @staticmethod
    def forward(ctx, group, t):
        ctx.group = group
        out = t.clone()
        group.reduce_(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        ctx.group.reduce_(grad)
        return None, grad


class BatchGroup:
    """The ranks that share one global batch: this rank's index `rank` of
    `size`, over the default process group.  Entered as a context
    (`with group:`), it is what `current_group()` returns.  With size 1 it
    is the identity: `rows` returns its argument, the reductions return
    theirs, and nothing is communicated.  `reduce_` (an in-place sum over
    the ranks) is the one collective the other methods use."""

    def __init__(self, rank: int = 0, size: int = 1):
        self.rank, self.size = int(rank), int(size)
        # per thread: one group may be entered by several threads at once
        self._tokens = threading.local()

    @property
    def distributed(self) -> bool:
        return self.size > 1

    def reduce_(self, t):
        """Sum `t` over the ranks, in place."""
        dist.all_reduce(t)

    def rows(self, x):
        """This rank's row block of a global [B, ...] tensor."""
        if not self.distributed:
            return x
        return x[local_rows(x.shape[0], self.rank, self.size)]

    def all_sum(self, t):
        """The sum over the ranks (no gradient)."""
        if not self.distributed:
            return t
        out = t.detach().clone()
        self.reduce_(out)
        return out

    def sum(self, t):
        """The sum over the ranks, differentiable: the gradient reaching
        each rank's `t` is the sum of every rank's gradient of the sum."""
        if not self.distributed:
            return t
        return _AllReduceSum.apply(self, t)

    def gather(self, t):
        """Every rank's `t` [n, ...] in rank order -> [size * n, ...] (no
        gradient): each rank writes its rows into a zero-filled global
        buffer, then one all-reduce."""
        if not self.distributed:
            return t
        n = t.shape[0]
        dt = torch.int32 if t.dtype == torch.bool else t.dtype
        buf = torch.zeros((self.size * n, *t.shape[1:]), dtype=dt,
                          device=t.device)
        buf[self.rank * n:(self.rank + 1) * n] = t.detach()
        self.reduce_(buf)
        return buf.bool() if t.dtype == torch.bool else buf

    def broadcast_(self, t, src: int = 0):
        """Overwrite `t` with rank `src`'s, in place."""
        if self.distributed:
            dist.broadcast(t, src)

    def __enter__(self):
        stack = self._tokens.__dict__.setdefault('stack', [])
        stack.append(_CURRENT.set(self))
        return self

    def __exit__(self, *exc):
        _CURRENT.reset(self._tokens.stack.pop())
        return False


SINGLE = BatchGroup()
_CURRENT = contextvars.ContextVar('dana_batch_group', default=SINGLE)


def current_group() -> BatchGroup:
    """The BatchGroup the running step entered, or the identity."""
    return _CURRENT.get()


__all__ = ['init_distributed', 'shutdown', 'is_multiprocess', 'agree_stop',
           'barrier', 'local_rows', 'rank_device',
           'choose_backend', 'BatchGroup', 'SINGLE', 'current_group']
