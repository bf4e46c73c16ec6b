"""Host utilities of the port: the ``HYDRAGNN_*`` environment flags and
the SIGTERM preemption flag."""
