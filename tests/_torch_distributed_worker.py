"""Worker of the port's two-process test (``tests/test_torch_distributed.py``).

Usage: python tests/_torch_distributed_worker.py RANK NPROC PORT OUTDIR

Each process joins a gloo group through ``initialize_distributed`` and
holds 4 CPU entries; together they form one chain mesh of 8 entries. The
worker runs ``run_mclmc`` over that mesh, a round trip of the draws
through ``torch.distributed.checkpoint`` written by both ranks, the
in-step check on equal and on differing arrays, and the trainer (4
chains over 2 CPU entries a rank). Rank 0 writes the results.
"""
import os
import sys

rank, nproc, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3], sys.argv[4])
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, 'tests')]
os.chdir(ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from _torch_distributed_workload import (  # noqa: E402
    run_chains,
    trainer_config,
)

from mile_tpu_torch.parallel import distributed  # noqa: E402
from mile_tpu_torch.parallel.mesh import chain_mesh  # noqa: E402

assert distributed.initialize_distributed(f'localhost:{port}', nproc, rank)
group = distributed.process_group()
assert distributed.is_primary_host() == (rank == 0)

mesh = chain_mesh(devices=['cpu'] * 4, group=group)
assert mesh.size == 4 * nproc and mesh.shape == {'chains': 4 * nproc}
result = run_chains(mesh)

# every rank writes its part of the checkpoint; every rank reads it back
from mile_tpu_torch.train.checkpoint_orbax import (  # noqa: E402
    load_ensemble,
    save_ensemble,
)

samples = torch.from_numpy(result.samples)
save_ensemble(os.path.join(outdir, 'dcp'), {'draws': {'positions': samples}})
restored = load_ensemble(os.path.join(outdir, 'dcp'))
assert torch.equal(restored['draws']['positions'], samples), 'DCP round trip'

distributed.check_in_step(result.samples, group)
try:
    distributed.check_in_step(np.full(3, rank), group)
    raise AssertionError('ranks out of step were not caught')
except RuntimeError as exc:
    assert 'out of step' in str(exc)

from mile_tpu_torch.config import Config  # noqa: E402
from mile_tpu_torch.train.trainer import BDETrainer  # noqa: E402

trainer = BDETrainer(Config.from_dict(trainer_config(
    os.path.join(outdir, 'runs'))), devices=['cpu'] * 2)
assert trainer.mesh.size == 4 and trainer.mesh.group is group
members = trainer.train_warmstart()
run = trainer.start_sampling(members)
metrics = trainer.evaluate(members, run)
distributed.check_in_step(run.samples, group, 'trainer draws')

if rank == 0:
    np.savez(os.path.join(outdir, 'distributed.npz'),
             samples=result.samples, restored=restored['draws']['positions'],
             trainer_samples=run.samples, lppd=metrics['lppd'],
             exp_dirs=np.array(sorted(os.listdir(os.path.join(outdir,
                                                              'runs')))))
torch.distributed.barrier()
torch.distributed.destroy_process_group()
print(f'rank {rank} ok', flush=True)
