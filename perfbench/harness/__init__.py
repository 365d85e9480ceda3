"""The benchmark's harness: the manifest, the run's environment, the
profiler window, the peak table and the result line.  Nothing here
imports numpy or torch when the package is imported, so ``run.py`` can
fix the thread counts before either loads."""
