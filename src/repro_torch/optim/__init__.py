"""Optimizers and schedules, updating in place (port of ``repro.optim``);
gradient compression for cross-shard sync is ``optim.compression``.
"""
from repro_torch.optim.adafactor import adafactor_init, adafactor_update
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.sgd import sgd_init, sgd_update

OPTIMIZERS = {
    "adamw": (adamw_init, adamw_update),
    "adafactor": (adafactor_init, adafactor_update),
    "sgd": (sgd_init, sgd_update),
}


def get_optimizer(name):
    return OPTIMIZERS[name]
