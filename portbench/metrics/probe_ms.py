"""ms a block in ``serving/batched.batch_probe``'s probe stage: the
collision count, the max over offsets and ``top_c_by_count``,
``StageTimer`` "probe", synchronised."""
from portbench.metrics._stages import mean_ms


def read(obs):
    return mean_ms(obs, ("probe",))
