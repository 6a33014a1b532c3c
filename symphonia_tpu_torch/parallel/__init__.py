"""Multi-card shell of the port: the (dp, tp) mesh of ranks
(:mod:`.mesh`) and the combined decode step sharded over it with
``torch.distributed`` (:mod:`.step`), the counterpart of the reference's
``symphonia_tpu/parallel/`` and of the reference's ``dryrun_multichip``
(``__graft_entry__.py:181``; here ``entry.dryrun_multichip``)."""
