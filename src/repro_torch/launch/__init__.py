"""Launchers of the port; counterpart of ``repro.launch``.

``mesh``  — the ``torch.distributed`` group and the DP process groups.
``train`` — ``python -m repro_torch.launch.train``: DP ranks, one process
            each.
"""
