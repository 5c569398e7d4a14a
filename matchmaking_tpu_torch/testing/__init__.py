"""Helpers shipped with the package for soaks and test suites:
``drain.fully_drained``, the settle predicate of a soak's quiesce loop."""
