"""Scene data of the port.  The SAPIEN loaders are not ported yet (ROADMAP.md
slice 4); ``analytic`` builds small in-memory scenes, one of them articulated,
for smoke runs and tests."""
