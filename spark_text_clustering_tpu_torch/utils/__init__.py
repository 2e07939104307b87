"""Host utilities of the port: vocabulary, scoring report, timers."""
