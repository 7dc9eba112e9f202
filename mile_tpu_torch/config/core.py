"""Top-level experiment configuration (counterpart of
``mile_tpu/config/core.py``). The same YAMLs load unchanged."""
from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Any, Mapping

import yaml

from mile_tpu_torch.config.base import BaseConfig
from mile_tpu_torch.config.data import DataConfig
from mile_tpu_torch.config.models import ModelConfig
from mile_tpu_torch.config.training import TrainingConfig
from mile_tpu_torch.utils.precision import none_precision

logger = logging.getLogger(__name__)
RECORDED_NONE_PRECISION = 'none_precision'


@dataclasses.dataclass(frozen=True)
class Config(BaseConfig):
    """Root config: data + model + training + bookkeeping."""

    saving_dir: str
    experiment_name: str
    data: DataConfig
    model: ModelConfig
    training: TrainingConfig = dataclasses.field(default_factory=TrainingConfig)
    rng: int = 42
    logging: bool = True
    profile: bool = False

    # ``model:`` needs polymorphic resolution by its ``model`` name.
    # ``none_precision`` is what a written config.yaml records of its run
    # (see ``setup_dir``), not a setting: read back, it is dropped.
    @classmethod
    def from_dict(cls, data: Mapping[str, Any], _path: str = '') -> 'Config':
        data = dict(data)
        data.pop(RECORDED_NONE_PRECISION, None)
        if 'model' in data and isinstance(data['model'], dict):
            data['model'] = ModelConfig.resolve(data['model'])
        return super().from_dict(data, _path=_path)

    @property
    def experiment_dir(self) -> Path:
        return Path(self.saving_dir) / self.experiment_name

    def setup_dir(self) -> Path:
        """Create the experiment dir (timestamp-suffixed on collision),
        dump config.yaml, and configure logging. Where a None matmul
        precision stands for another arithmetic than the port's exact
        default (``'bfloat16'`` under a runner's ``--tpu-arithmetic``),
        config.yaml records it as ``none_precision``, and so does each row
        of a pooled study; a run at the default records nothing, so that
        the JAX package reads its directory as before."""
        exp_dir = self.experiment_dir
        if exp_dir.exists() and any(exp_dir.iterdir()):
            stamped = Path(f'{exp_dir}_{int(time.time())}')
            logger.warning('experiment dir %s exists; using %s', exp_dir, stamped)
            exp_dir = stamped
        exp_dir.mkdir(parents=True, exist_ok=True)
        record = ({} if none_precision() == 'float32' else
                  {RECORDED_NONE_PRECISION: none_precision()})
        with open(exp_dir / 'config.yaml', 'w') as f:
            yaml.safe_dump({**self.to_dict(), **record}, f, sort_keys=False)
        if self.logging:
            self._setup_logging(exp_dir)
        return exp_dir

    def _setup_logging(self, exp_dir: Path) -> None:
        root = logging.getLogger()
        root.setLevel(logging.INFO)
        # one experiment log at a time: drop the previous experiment's handler
        for h in list(root.handlers):
            if getattr(h, '_mile_experiment_log', False):
                root.removeHandler(h)
                h.close()
        fmt = logging.Formatter('%(asctime)s %(levelname)s %(name)s: %(message)s')
        fh = logging.FileHandler(exp_dir / 'training.log')
        fh.setFormatter(fmt)
        fh._mile_experiment_log = True
        root.addHandler(fh)

    def get_model(self, input_shape: int | tuple[int, ...]):
        """Build the configured network for observations of
        ``input_shape`` (the loader's ``input_shape``)."""
        from mile_tpu_torch.models import build_model

        return build_model(self.model, input_shape)
