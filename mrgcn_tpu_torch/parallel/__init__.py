"""Multi-device training over ``torch.distributed``: the mesh, its
sharding rules and the world's processes (:mod:`.mesh`), and the
collectives with their transposes (:mod:`.collectives`)."""
