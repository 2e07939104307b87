"""Host utilities of the port: the text front end (readers, the Python
text path and the native library's bindings), vocabulary, scoring report,
timers and metrics."""
