"""Multi-device layer of the port: logical sharding rules (``mesh``),
parameter / batch / cache layouts (``sharding``) and the
sequence-parallel decode collective (``collectives``)."""
