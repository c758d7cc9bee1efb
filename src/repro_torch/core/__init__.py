"""The plan stack of the port (the counterpart of ``repro.core``):

  pipe            :class:`~repro_torch.core.pipe.Pipe`, the shared-memory
                  budget, ``required_depth``
  pipeline_model  the analytic DAE model and the hardware descriptors
                  (``ARRIA_CX``, ``TPU_V5E``, ``H100_SXM``)
  meshspec        the topology token of plan keys
  planner         ``plan_pipe`` and the per-call-site plan cache
  profiling       the traffic-recording hook of the plan service
  program         ``PipePolicy``, the session policy, ``make_entrypoint``;
                  the StreamProgram declarations and ``compile_program``
                  (a declaration bound to its hand-written launch)
  graph           ``StreamGraph``, ``check_fusion``, ``compile_graph``
                  (fused chains onto the hand-fused kernels)
  autotune        the measured lookup chain (memory, disk, PlanDB,
                  measure, analytic)
  feedforward     ``StreamSpec`` and its oracle ``run_reference``, the
                  MLCD check: the contract the kernels are tested against

None of it imports a kernel at import time: the kernels import it, and
``compile_program`` / ``compile_graph`` import a launch when they bind
it.
"""
