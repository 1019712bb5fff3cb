from .ampc import AMPCNet
from .temporal_unet import PointUnet, TemporalUnet
from .weights import (FLAGSHIP_CONFIG, LMPC_CONFIG, PANDA_STUDENT_CONFIG, QUADROTOR_STUDENT_CONFIG,
                      QUADROTOR_TEACHER_CONFIG, SCENE_STUDENT_CONFIG, TEACHER_CONFIG, from_flax_params, init_like_flax,
                      init_mlp_like_flax, load_ampc, load_flagship, load_lmpc, load_panda_student,
                      load_panda_teacher, load_quadrotor_student, load_quadrotor_teacher, load_scene_student, load_student,
                      load_teacher, mlp_from_flax_params, mlp_to_flax_params,
                      point_unet_from_flax_params, to_flax_params)

__all__ = ["AMPCNet", "PointUnet", "TemporalUnet", "FLAGSHIP_CONFIG", "LMPC_CONFIG", "PANDA_STUDENT_CONFIG",
           "QUADROTOR_STUDENT_CONFIG", "QUADROTOR_TEACHER_CONFIG", "SCENE_STUDENT_CONFIG", "TEACHER_CONFIG", "from_flax_params", "init_like_flax",
           "init_mlp_like_flax", "load_ampc", "load_flagship", "load_lmpc", "load_panda_student",
           "load_panda_teacher",
           "load_quadrotor_student", "load_quadrotor_teacher", "load_scene_student", "load_student", "load_teacher", "mlp_from_flax_params",
           "mlp_to_flax_params", "point_unet_from_flax_params", "to_flax_params"]
