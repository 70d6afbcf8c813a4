"""Scene data of the port.  The SAPIEN loaders are not ported yet (ROADMAP.md
slice 6); ``analytic`` builds small in-memory scenes, one of them articulated,
for smoke runs and tests."""
