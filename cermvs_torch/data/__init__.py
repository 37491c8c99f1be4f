"""Dataset registry and loader factories: ``get_test_data_loader``
(un-batched, ordered, optional (start, end, step) subset) and
``get_train_data_loader`` (shuffled, drop_last) over the registered
datasets: DTU, DTUTest, Blended, TNT and Custom.
"""

from __future__ import annotations

from cermvs_torch.config import configurable
from cermvs_torch.data.blended import Blended
from cermvs_torch.data.custom import Custom
from cermvs_torch.data.dtu import DTU, DTUTest
from cermvs_torch.data.loader import DataLoader
from cermvs_torch.data.tnt import TNT

dataset_dict = {
    "DTU": DTU,
    "DTUTest": DTUTest,
    "Blended": Blended,
    "TNT": TNT,
    "Custom": Custom,
}


def _dataset(name):
    if name not in dataset_dict:
        raise KeyError(f"unknown dataset {name!r}; known: "
                       f"{sorted(dataset_dict)}")
    return dataset_dict[name]


@configurable("get_test_data_loader")
def get_test_data_loader(datasetname=None, num_frames=10, subset=None,
                         num_workers=4, **args):
    if subset is not None:
        start, end, step = subset
        subset = list(range(start, end, step))
    dataset = _dataset(datasetname)(num_frames=num_frames, subset=subset,
                                    **args)
    return DataLoader(dataset, batch_size=None, shuffle=False,
                      num_workers=num_workers)


@configurable("get_train_data_loader")
def get_train_data_loader(datasetname=None, batch_size=2, num_frames=10,
                          num_workers=4, seed=0, process_shard=None, **args):
    """``process_shard=(process_id, process_count)`` loads one process's
    slice of every batch; None loads whole batches."""
    dataset = _dataset(datasetname)(num_frames=num_frames, **args)
    return DataLoader(dataset, batch_size=batch_size, shuffle=True,
                      drop_last=True, num_workers=num_workers, seed=seed,
                      process_shard=process_shard)
