"""Launchers of the port; counterpart of ``repro.launch``.

``mesh``           — the ``torch.distributed`` group, the DP and TP process
                     groups, the production layouts and the fake group.
``steps``          — the step builders and argument structs of every
                     (arch x shape x mesh) cell.
``train``          — ``python -m repro_torch.launch.train``: DP x TP ranks,
                     one process each.
``dryrun``         — ``python -m repro_torch.launch.dryrun``: every cell
                     traced on ``meta`` tensors, without a card.
``trace_analysis`` — FLOPs, traffic, collective bytes and the overlap
                     audit of a traced step (the reference's
                     ``hlo_analysis``).
``reanalyze``      — ``traffic_bytes`` again from saved op logs.
"""
